from .sr import SRInference  # noqa: F401
