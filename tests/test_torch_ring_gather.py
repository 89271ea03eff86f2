"""The port's descriptor pass (``Transport.assemble_desc``) and the plain
gather of ``ops/ring_gather.py`` against the JAX package's copying
assembler on the same pushes: the gathered batches bit for bit, the reset
and underrun masks, the live count, every push's result and the buffered
frames, in the scenarios of ``tests/torch_ingest_scenarios.py``; the
deferred release of ring space; the row counters.  The card's kernel is
held to the plain gather in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ingest_scenarios import (  # noqa: E402
    B,
    SCENARIOS,
    Script,
    apply,
    assert_same_hops,
    run_copying,
    run_descriptors,
    seconds,
)

from openmeters_tpu.ingest import transport as jingest  # noqa: E402
from openmeters_tpu_torch.ingest import Transport  # noqa: E402
from openmeters_tpu_torch.ingest.transport import ROW_KINDS  # noqa: E402
from openmeters_tpu_torch.ops.ring_gather import ring_gather, ring_gather_reference  # noqa: E402

# the row kind each scenario must produce at least once
EXERCISES = {
    "steady": "one_segment",
    "ring_wrap": "two_segments",
    "partial_spans": "zero",
    "silence_gap": "staged",
    "mono_stream": "staged",
    "idle_watchdog": "zero",
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_descriptor_pass_gathers_what_the_jax_assembler_writes(name):
    script = SCENARIOS[name]()
    copying, described = jingest.Transport(**script.transport), Transport(**script.transport)
    ref = run_copying(copying, script)
    ours = run_descriptors(described, script)
    assert_same_hops(ours, ref, name)
    rows = dict(zip(ROW_KINDS, described.ingest_rows.tolist()))
    assert sum(rows.values()) == script.hops * script.n_streams
    if name in EXERCISES:
        assert rows[EXERCISES[name]] > 0, rows
    for st in range(script.n_streams):
        assert described.buffered_frames(st) == copying.buffered_frames(st)


def test_a_push_into_held_space_waits_for_release():
    """A ring of 8 blocks, full: after one pass reads a block, the JAX
    package's copying transport takes a block's push at once, the port's
    descriptor pass's transport only once a later pass into that buffer set
    releases it (a pass into it without ``release``, or into another set,
    frees nothing of it); both read the same buffered frames.  A fault
    discards the backlog at once, and its space too waits for the
    release."""
    script = Script(1, 1, seed=30, ring_seconds=seconds(8 * B))
    script.pcm(0, 0, 8 * B)
    script.pcm(0, 0, B)
    script.pcm(0, 0, B)
    script.pcm(0, 0, 2 * B)
    full, more, after, two = script.ops[0]
    copying = jingest.Transport(**script.transport)
    described, faulted = (Transport(**script.transport) for _ in range(2))
    for tp in (copying, described, faulted):
        assert apply(tp, full) == 0
    copying.assemble()
    described.assemble_desc(described.make_desc_buffers(), 0)
    assert copying.buffered_frames(0) == described.buffered_frames(0) == 7 * B
    assert described.backlog_blocks() == copying.backlog_blocks() == 7
    assert apply(copying, more) == 0
    described.assemble_desc(described.make_desc_buffers(), 0, release=False)
    described.assemble_desc(described.make_desc_buffers(), 1)
    assert described.buffered_frames(0) == 5 * B
    assert apply(described, more) == -2 and described.fault_count(0) == 1
    described.assemble_desc(described.make_desc_buffers(), 0)  # set 0's two blocks back
    assert apply(described, after) == 0

    faulted.assemble_desc(faulted.make_desc_buffers(), 0)
    faulted.push_fault(0)
    _, _, live = faulted.assemble_desc(faulted.make_desc_buffers(), 1)
    assert live == 0 and faulted.buffered_frames(0) == 0
    assert apply(faulted, more) == -2
    faulted.assemble_desc(faulted.make_desc_buffers(), 0)  # set 0's block back
    assert apply(faulted, two) == -2  # set 1's pass discarded the other 7 blocks: still held
    faulted.assemble_desc(faulted.make_desc_buffers(), 1)
    assert faulted.push_pcm(0, two[2], two[3] + 10**9) == 0


def test_ingest_rows_count_each_kind():
    """One hop of four streams: a row in one ring segment, one across the
    ring's end, a mono row (staged) and an idle one; before it, a pass of
    four idle rows that gives back the first hop's space."""
    tp = Transport(4, 2, B, 48_000.0, ring_seconds=seconds(3 * B // 2))
    bufs = tp.make_desc_buffers()
    x = np.ones((B, 2), np.float32)
    tp.push_pcm(0, x, 0)
    tp.push_pcm(1, x, 0)
    tp.assemble_desc(bufs, 0)
    tp.assemble_desc(bufs, 0)
    tp.set_channels(2, 1)
    tp.push_pcm(1, np.ones((B, 2), np.float32), int(B / 48e3 * 1e9))  # wraps at 1.5 blocks
    tp.push_pcm(2, np.ones((B, 1), np.float32), 0)
    before = tp.ingest_rows.copy()
    tp.assemble_desc(bufs, 1)
    assert dict(zip(ROW_KINDS, (tp.ingest_rows - before).tolist())) == {
        "one_segment": 0, "two_segments": 1, "staged": 1, "zero": 2}
    assert bufs[3][2].tolist() == [0, -1, 0, 0]
    assert tp.ingest_rows.tolist() == [2, 1, 1, 8]


def test_meter_server_reports_ingest_rows():
    from torch_pairs import tiny_engine

    from openmeters_tpu_torch.serve import MeterServer, ServeConfig

    srv = MeterServer(ServeConfig(n_streams=3, engine=tiny_engine(), realtime=False, fetch="none"), device="cpu")
    try:
        for i in range(4):
            for st in range(2):
                srv.transport.push_pcm(st, np.full((B * 4, 2), 0.1, np.float32), int(i * B * 4 / 48e3 * 1e9))
            srv.advance()
        rows = srv.report()["ingest_rows"]
    finally:
        srv.close()
    assert set(rows) == set(ROW_KINDS)
    assert sum(rows.values()) == 3 * srv.stats.hops
    assert rows["zero"] == srv.stats.hops and rows["staged"] == 0


def _gather_loop(arena, staging, desc, rows, row_len, row0):
    """The descriptors' meaning, one element at a time."""
    out = np.zeros((rows, row_len), np.float32)
    for r in range(rows):
        off0, n0, off1, n1 = desc[row0 + r]
        if n0 < 0:
            out[r] = staging[row0 + r]
            continue
        for j in range(row_len):
            if j < n0:
                out[r, j] = arena[off0 + j]
            elif j < n0 + n1:
                out[r, j] = arena[off1 + j - n0]
    return out


@pytest.mark.parametrize("row0", [0, 3])
def test_plain_gather_follows_the_descriptors(row0):
    """Odd offsets and lengths, a wrap, a staged row, a zero row, a row
    range past the first stream; every element of ``out`` written."""
    rng = np.random.default_rng(31)
    row_len = 12
    arena = rng.standard_normal(200).astype(np.float32)
    arena[7] = -0.0
    staging = rng.standard_normal((8, row_len)).astype(np.float32)
    desc = np.array([[5, 12, 0, 0], [11, 3, 190, 9], [0, -1, 0, 0], [0, 0, 0, 0], [101, 7, 0, 0],
                     [190, 10, 0, 2], [0, -1, 0, 0], [3, 4, 50, 4]], np.int64)
    rows = 5
    out = torch.full((rows, row_len // 2, 2), float("nan"))
    ring_gather(torch.from_numpy(arena), torch.from_numpy(staging), torch.from_numpy(desc), out, row0=row0)
    want = _gather_loop(arena, staging, desc, rows, row_len, row0)
    np.testing.assert_array_equal(out.numpy().reshape(rows, row_len).view(np.uint32), want.view(np.uint32))
    with pytest.raises(ValueError, match="outside"):
        ring_gather_reference(torch.from_numpy(arena), torch.from_numpy(staging), torch.from_numpy(desc),
                              torch.zeros((rows, row_len)), row0=4)
