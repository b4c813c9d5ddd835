from .masked import masked_mean, masked_softmax, merge_masks  # noqa: F401
