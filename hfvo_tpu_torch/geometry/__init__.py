from . import se3, camera  # noqa: F401
