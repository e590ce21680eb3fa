"""The benchmark's yardstick: the roofline arithmetic of the port's kernels
(:mod:`.roofline`) and the card's peaks (:mod:`.flops`).  Each
architecture's model operations are in ``portbench/counts/``."""
