"""Plain PyTorch geometry ops: the specification of the grouping kernels."""
