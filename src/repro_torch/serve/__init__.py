from .engine import Request, Result, ServeEngine  # noqa: F401
