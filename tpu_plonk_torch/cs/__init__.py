from .composer import Composer, PointVar  # noqa: F401
