from .stopwatch import Stopwatch

__all__ = ["Stopwatch"]
