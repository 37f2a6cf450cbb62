from .engine import ServeEngine  # noqa: F401
