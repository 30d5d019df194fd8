from . import cost_model  # noqa: F401
