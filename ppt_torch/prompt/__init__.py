"""CLIP tokenizer and the prompt learner splice."""
