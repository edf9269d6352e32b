from . import trajectory, evaluate  # noqa: F401
