"""Network modules: shared layers, the PointBERT trunk and the CLIP text tower."""
