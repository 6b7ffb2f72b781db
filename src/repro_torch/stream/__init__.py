"""Streaming inserts: a live delta segment over the frozen graph
(counterpart of ``repro.stream``).

``StreamingJAGIndex`` wraps a built ``JAGIndex`` with a growable
``DeltaSegment`` and an epoch counter: inserts are amortized O(1) appends,
searches merge the routed graph result with an exact delta scan, and
compaction folds the delta into the graph with the build's batch-insert
step. See stream/index.py.
"""
from .delta import DeltaSegment
from .index import StreamingJAGIndex

__all__ = ["DeltaSegment", "StreamingJAGIndex"]
