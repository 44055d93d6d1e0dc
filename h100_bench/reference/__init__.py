"""Plain PyTorch references that decide a run's ``correct``.

Each module here is written from the published description of its model
part, in float32 with TF32 off, and imports nothing of the program under
test: it gets the same seeded weights and inputs as the program and works
out everything else again. ``precision.Products`` gives their matrix
products, in float32 or, for the control that has to fail, in fp8.
"""
