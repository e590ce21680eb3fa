"""Model operations of an MLP training sample: each dense layer's forward,
dx and dW contractions, but for the first layer's dx."""


def train_ops_per_sample(spec) -> int:
    macs = [a * b for a, b in zip(spec.sizes, spec.sizes[1:])]
    return 2 * (3 * sum(macs) - macs[0])
