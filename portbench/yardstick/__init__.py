"""The benchmark's yardstick: the roofline arithmetic of the port's kernels
(:mod:`.roofline`) and the model's operation count and the card's peaks
(:mod:`.flops`)."""
