"""Runtime layer: native IQ ingest and the streaming tracker."""

from . import iq
from .iq import IQFile, IQRing, Resampler, decode, native_available
from .stream import StreamResult, StreamTracker, blocks, track_file

__all__ = [
    "iq",
    "IQFile",
    "IQRing",
    "Resampler",
    "decode",
    "native_available",
    "StreamResult",
    "StreamTracker",
    "blocks",
    "track_file",
]
