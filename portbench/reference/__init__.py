"""The plain reference of the cells: a ResNet-50 DFXP training step in
plain PyTorch and NumPy, written from the architecture (He et al. 2015,
Table 1) and the DFXP rules.  It imports nothing of ``lbt_tpu_torch``;
the noise streams and the key chain it needs are frozen copies in
:mod:`portbench.reference.noise`."""
