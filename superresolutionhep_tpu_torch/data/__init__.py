from .jagged import JaggedArray, Jagged2Array  # noqa: F401
from . import root_io  # noqa: F401
