from . import alibaba  # noqa: F401
