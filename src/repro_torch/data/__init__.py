from .synthetic import MarkovLM  # noqa: F401
