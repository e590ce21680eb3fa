"""#4 and #5, the fused 3x3 and 1x1 int8 convs
(``ops/kernels/conv_fused.py``, ``csrc/conv_fused*.cu``), as the convs
call them (``ops/qops.py``).  Their roofline is in ``int8mm_roofline``."""

WRAPS = (("lbt_tpu_torch.ops.qops", "conv3x3_fused"),
         ("lbt_tpu_torch.ops.qops", "conv1x1_fused"))
COUNTERS = {"conv3x3": ("lbt_tpu_torch.ops.kernels.conv_fused",
                        "conv3x3_fused"),
            "conv1x1": ("lbt_tpu_torch.ops.kernels.conv_fused",
                        "conv1x1_fused")}
CLASS = "fused"
DEVICE_NAMES = ("conv_fused_kernel",)


def record(out, xc, wc, inv_scale, mult_out, *, strides, pads, bits_out=8,
           noise=None, round_bf16=False):
    """``(x shape, bytes an x code, w shape, strides, pads, noise mode)``,
    the arguments of ``yardstick.roofline.conv_fused_work``."""
    return (tuple(xc.shape), xc.element_size(), tuple(wc.shape),
            tuple(strides), tuple(map(tuple, pads)),
            0 if noise is None else noise.mode)
