"""The benchmark's own check of the served loudness path: the CPU cut of
``loudness.served`` in ``meterbench/tests/_cpu_cell.py`` (four streams
through ``MeterServer``, the producer flat out under backpressure) run for
a 3 s window and judged by ``meterbench/check.py`` against its float64
reference under the cell's limits, as the benchmark judges a run on the
card.  The port's other tests hold it to the JAX package; this one holds
the served loop's meters to the benchmark's reference.  It guards the
served loop's numerics on the CPU, not what only a card's run of thousands
of streams shows: a producer that falls behind the server and underruns
the sampled streams."""

import pytest

torch = pytest.importorskip("torch")

from meterbench import check, served  # noqa: E402
from meterbench.tests._cpu_cell import run_small, small_cell  # noqa: E402

SEED = 2**31 + 22


@pytest.fixture
def two_torch_threads():
    """Four streams: two intra-op threads are enough and leave the cores
    to the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_served_loudness_passes_the_benchmark_check(two_torch_threads):
    run = run_small(SEED, seconds=3.0)
    assert run.hops > 0 and run.fetches > 0
    assert run.resets == run.underruns == run.pushes_refused == 0
    cell = small_cell()
    found = check.numbers(cell, run, lambda k, n: served.samples(run, k, n))
    assert check.verdict(found, cell.config["limits"]), found
