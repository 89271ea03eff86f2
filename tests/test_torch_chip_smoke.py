"""The chip smoke script's helpers, on the CPU: ``chip_smoke.py`` phase 15
counts the instructions a sample that the crossover kernel's sample loops
issue (``three_band_issue``) and works out the serial chain's floor from
them (``three_band_chain_floor_ms``), here from synthetic ``cuobjdump
-sass`` text, so neither ``nvcc`` nor a card is needed; phase 22a holds the
card's rendered panes against the CPU's (``compare_renders``); phase 23
joins a sharded server's meter vectors leaf by leaf (``join_by_leaf``) and
compares the shards' replicated host scalars (``replicated_mismatches``);
phase 24b recomputes a hop's last spectrogram column exactly from the
carry's rings (``exact_errors``) and makes its audio on the card a block at
a time (``CardProgramme``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def _sass(symbol, body):
    """``cuobjdump -sass`` text of one function: ``body`` a list of
    instructions, ``"BRA <index>"`` a branch to the ``index``-th."""
    lines = [f"\t\tFunction : {symbol}", '\t.headerflags\t@"EF_CUDA_SM90"']
    for i, text in enumerate(body):
        if text.startswith("BRA "):
            text = f"@P1 BRA {16 * int(text.split()[1]):#x}"
        lines += [f"        /*{16 * i:04x}*/                   {text} ;      /* 0x000fe40000000800 */",
                  "                                                              /* 0x000fc80000000000 */"]
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("warps", [1, 2])
def test_three_band_issue_reads_sass(monkeypatch, warps):
    """``three_band_issue`` counts the instructions a sample of the
    innermost loops with the most products in ``cuobjdump -sass`` text:
    for the LR4 instance (40 products a lane's sample), ``warps`` loops of
    two samples each (40 / warps products a sample), a tail loop of one
    sample, and a barrier wait's retry placed after the body, which
    branches back across the loops and is no loop of its own."""
    from openmeters_tpu_torch.ops import _build

    per_warp = 40 // warps
    body = ["LDC R1, c[0x0][0x28]", "SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [R2], R3"]
    for n in [2 * per_warp] * warps + [per_warp]:
        start = len(body)
        body += ["FMUL R4, R5, R6"] * n + ["FADD R4, R5, R6"] * 9 + ["NOP", f"BRA {start}"]
    body += ["EXIT", "BRA 1", "BRA " + str(len(body) + 2)]  # the retry, then the trap loop
    text = _sass("_ZN12_GLOBAL__N_117three_band_kernelILi2ELb1EEEvPKfS2_S2_PfS3_ii", body)
    text += _sass("_ZN12_GLOBAL__N_117sliding_hop_kernelEv", ["FMUL R1, R2, R3", "BRA 0"])
    monkeypatch.setattr(_build, "find_nvcc", lambda: "/cuda/bin/nvcc")
    monkeypatch.setattr(_build.subprocess, "run", lambda *a, **k: type("Done", (), {"stdout": text})())
    issue = chip_smoke.three_band_issue("lib.so")
    want = (2 * per_warp + 9 + 1) / 2  # a loop's products, sums and branch over its two samples
    assert issue == {(2, True): [want] * warps}
    floor = chip_smoke.three_band_chain_floor_ms(1024, 4096, issue[(2, True)], 2000.0, 132)
    # 128 tiles on 132 SMs: each warp's own chain bounds it, 1024 samples at 2 GHz
    assert floor == pytest.approx(1024 * want / 2e6)


def _panes(directory, images: dict) -> None:
    from openmeters_tpu_torch.render import write_png

    directory.mkdir()
    for name, img in images.items():
        write_png(directory / f"{name}.png", img)


def _images(seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {"spectrum": rng.integers(0, 256, (54, 96, 3), dtype=np.uint8),
            "loudness": rng.integers(0, 256, (54, 32, 3), dtype=np.uint8)}


@pytest.mark.parametrize("change", ["identical", "within_bar"])
def test_compare_renders_passes_images_within_the_bar(tmp_path, change):
    """Identical panes pass, and so do panes with fewer pixels off than the
    bar's share; the errors come back by pane."""
    from openmeters_tpu_torch.utils.parity import PIXEL_LEVELS, PIXEL_SHARE

    ref = _images()
    ours = {k: v.copy() for k, v in ref.items()}
    if change == "within_bar":
        img = ours["spectrum"]
        img.reshape(-1, 3)[: int(PIXEL_SHARE * img.shape[0] * img.shape[1])] ^= 0x40
    _panes(tmp_path / "card", ours)
    _panes(tmp_path / "cpu", ref)
    errors = chip_smoke.compare_renders(tmp_path / "card", tmp_path / "cpu")
    assert set(errors) == {"spectrum", "loudness"}
    if change == "identical":
        assert all(e == {"off_share": 0.0, "mean_levels": 0.0, "max_levels": 0} for e in errors.values())
    else:
        assert 0 < errors["spectrum"]["off_share"] <= PIXEL_SHARE < 1 and errors["spectrum"]["max_levels"] > PIXEL_LEVELS


@pytest.mark.parametrize("fault", ["off_share", "mean", "missing_pane", "shape"])
def test_compare_renders_flags_images_off_the_bar(tmp_path, fault):
    """A pane with more pixels off than the bar's share, one whose every
    pixel is off by more than the mean bar (none by more than the level
    bar), a pane written on one side only, or panes of other sizes: each
    raises."""
    from openmeters_tpu_torch.utils.parity import MEAN_LEVELS, PIXEL_LEVELS, PIXEL_SHARE

    ref = _images()
    ours = {k: v.copy() for k, v in ref.items()}
    img = ours["spectrum"]
    if fault == "off_share":
        n = int(2 * PIXEL_SHARE * img.shape[0] * img.shape[1]) + 1
        img.reshape(-1, 3)[:n] ^= 0x80
    elif fault == "mean":
        step = min(PIXEL_LEVELS, int(MEAN_LEVELS) + 1)
        ours["spectrum"] = np.where(img < 128, img + step, img - step).astype(np.uint8)
    elif fault == "missing_pane":
        del ours["loudness"]
    else:
        ours["spectrum"] = img[:-1]
    _panes(tmp_path / "card", ours)
    _panes(tmp_path / "cpu", ref)
    with pytest.raises((AssertionError, ValueError)):
        chip_smoke.compare_renders(tmp_path / "card", tmp_path / "cpu")


def _sharded_meters(n: int):
    """A two-leaf meter layout over 4 streams (a ``[4]`` leaf, a ``[2, 4,
    3]`` leaf with its stream dim second), its values, and the ``n``
    shards' leaf-major vectors."""
    rng = np.random.default_rng(5)
    leaves = [rng.standard_normal((4,)).astype(np.float32), rng.standard_normal((2, 4, 3)).astype(np.float32)]
    layout, dims = [("a", (4,)), ("b", (2, 4, 3))], [0, 1]
    per = 4 // n
    vecs = [np.concatenate([leaves[0][i * per:(i + 1) * per].ravel(), leaves[1][:, i * per:(i + 1) * per].ravel()])
            for i in range(n)]
    return layout, dims, leaves, vecs


@pytest.mark.parametrize("n", [1, 2, 4])
def test_join_by_leaf_reassembles_shard_meter_vectors(n):
    """Each leaf's pieces joined along its stream dim give the unsharded
    vector; the shards' vectors concatenated whole do not (beyond one
    shard)."""
    layout, dims, leaves, vecs = _sharded_meters(n)
    whole = np.concatenate([leaf.ravel() for leaf in leaves])
    assert np.array_equal(chip_smoke.join_by_leaf(vecs, layout, dims), whole)
    assert np.array_equal(np.concatenate(vecs), whole) == (n == 1)


def test_join_by_leaf_refuses_a_vector_off_the_layout():
    layout, dims, _, vecs = _sharded_meters(2)
    with pytest.raises(ValueError, match="shard 1: 13 values, the layout holds 14 a shard"):
        chip_smoke.join_by_leaf([vecs[0], vecs[1][:-1]], layout, dims)


def test_replicated_mismatches_names_the_scalars_that_differ():
    """Equal host scalars and stream-sharded leaves that differ pass; a
    host scalar or a replicated tensor that differs is named by path."""
    import torch

    dims = {"buf": 0, "origin": None, "sub": {"count": None, "ring": (0, None)}}

    def shard(origin, count, ring_tail, buf):
        return {"buf": torch.full((2, 3), buf), "origin": origin,
                "sub": {"count": count, "ring": (torch.zeros(2), torch.full((3,), ring_tail))}}

    assert chip_smoke.replicated_mismatches([shard(4, 7, 0.5, 1.0), shard(4, 7, 0.5, 2.0)], dims) == []
    got = chip_smoke.replicated_mismatches([shard(4, 7, 0.5, 1.0), shard(5, 7, 0.25, 1.0)], dims)
    assert got == ["/origin", "/sub/ring/1"]


@pytest.mark.parametrize("reassigned", [False, True])
def test_exact_errors_hold_the_cpu_path(reassigned):
    """``exact_errors`` rebuilds the last window from the carry's rings:
    the port's CPU path over phase 24a's audio keeps its states within
    1e-5 of their row maximum of the exact ones on the hop before a
    re-anchor (63) and on the re-anchor hop (64), and its columns within
    the bars of the exact ones on the re-anchor hop (on the hop before it,
    31 hops of f32 drift put the time at the peak at the 1e-4 bar).  A
    window one hop off parts by more than 1e-2."""
    import torch

    from openmeters_tpu_torch.engine import MeterEngine, StreamMeta

    cfg = chip_smoke.reassigned_config() if reassigned else chip_smoke.flagship_config()
    engine, s = MeterEngine(cfg), 3
    meta = StreamMeta.default(s, channels=2, pad_channels=2)
    audio = chip_smoke.drift_audio(s, 65)
    carry = engine.init(s, device="cpu")
    for h in range(65):
        blk = torch.from_numpy(np.ascontiguousarray(audio[:, h * 256:(h + 1) * 256]))
        carry, snaps = engine.step(carry, blk, meta)
        if h >= 63:
            err = chip_smoke.exact_errors(engine, carry, snaps)
            for key, bar in chip_smoke.exact_bars().items():
                if key in err and h == 64:
                    assert err[key] <= bar, (h, key, err)
            assert err["state_u"] <= 1e-5, (h, err)
            info = chip_smoke.last_frames(engine.analyzers["spectrogram"], carry["spectrogram"], 4)
            shifted = {**carry, "spectrogram": {**carry["spectrogram"], "fb": {
                **carry["spectrogram"]["fb"], "origin": (carry["spectrogram"]["fb"]["origin"] + 64)}}}
            assert info["ready"] == 4
            off = chip_smoke.exact_errors(engine, shifted, snaps)
            assert off["state_u"] > 1e-2, (h, off)


def test_card_programme_blocks_follow_their_levels():
    """``CardProgramme`` (on the CPU here): a block's RMS follows its
    stream's level for the section; the same seed gives the same blocks."""
    a = chip_smoke.CardProgramme(6, 700, "cpu")
    b = chip_smoke.CardProgramme(6, 700, "cpu")
    blocks = [a.block(h) for h in range(620)]
    assert all(np.array_equal(x.numpy(), b.block(h).numpy()) for h, x in enumerate(blocks[:3]))
    x = np.concatenate([blk.numpy() for blk in blocks], axis=1).astype(np.float64)
    level = 20 * np.log10(a.gain.numpy())
    for j in range(2):
        sec = x[:, j * 300 * 256:(j + 1) * 300 * 256]
        rms = 10 * np.log10((sec ** 2).mean(axis=(1, 2)))
        # unit RMS on the left; the right channel's tone is 0.8 of it
        assert np.all(np.abs(rms - level[:, j]) < 1.5), (j, rms, level[:, j])
