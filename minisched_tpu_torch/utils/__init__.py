from .retry import retry_with_exponential_backoff  # noqa: F401
