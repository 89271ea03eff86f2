"""Host ingest: the native multi-stream transport and its batch assembly
(ctypes over C++; port of ``ingest/``).  Producers push PCM through
:class:`Transport`; the serving loop assembles fixed ``[n_streams, block,
channels]`` batches from it once a hop.  :class:`Feeder` runs native
synthetic producers for benchmarks."""

from openmeters_tpu_torch.ingest.transport import Feeder, Transport  # noqa: F401
