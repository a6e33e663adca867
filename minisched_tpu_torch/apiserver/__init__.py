from .client import RemoteStore  # noqa: F401
from .server import APIServer  # noqa: F401
