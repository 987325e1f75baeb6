from .merlin import Transcript  # noqa: F401
