from .dense import Dense, ACTIVATIONS  # noqa: F401
from .embed import TimestepEmbedder  # noqa: F401
from .attention import MultiheadAttention  # noqa: F401
from .dit import DiTLayer, DiTEncoder  # noqa: F401
from .flow_model import FlowModel  # noqa: F401
