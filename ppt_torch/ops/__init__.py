"""Plain PyTorch geometry ops: the specification of the grouping kernels
(``geometry``), and the packed-cloud ops of the scene backbones
(``ragged``)."""
