"""PyTorch port on a CUDA card: each kernel against its plain version on the
same card tensors.  Imports no JAX, so it also runs where only torch is
installed (``python -m pytest --noconftest tests/test_torch_cuda.py``).
Every test here skips where no card is present."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openmeters_tpu_torch.ops import sliding_hop as thop  # noqa: E402
from openmeters_tpu_torch.ops.sliding_stft import SlidingSTFT  # noqa: E402
from openmeters_tpu_torch.utils.level import DB_FLOOR  # noqa: E402
from openmeters_tpu_torch.utils.windows import (  # noqa: E402
    WindowKind,
    fft_bin_normalization,
    window_coefficients,
)

RESOLVED_CODES = round(60.0 * 65535 / 156)  # see tests/test_torch_sliding.py


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "fft,hop,block,window,s",
    [(2048, 64, 256, "hann", 100), (256, 32, 256, "blackman_harris", 37), (64, 16, 64, "blackman", 9)],
)
def test_sliding_hop_kernel_matches_plain(card, fft, hop, block, window, s):
    sl = SlidingSTFT(fft, hop, block, WindowKind(window))
    cols = sl.frames.cols_cap
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((s, fft + cols * hop)) * 0.3).astype(np.float32)
    spec = np.fft.rfft(x[:, :fft].astype(np.float64), axis=-1)
    deltas = np.stack(
        [x[:, fft + k * hop : fft + (k + 1) * hop] - x[:, k * hop : (k + 1) * hop] for k in range(cols)],
        axis=1,
    )
    fr, fi, deltas = (
        torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(card)
        for a in (spec.real, spec.imag, deltas)
    )
    rot_r, rot_i, upd_r, upd_i, dc = sl._tensors(card)
    norm = torch.from_numpy(
        fft_bin_normalization(window_coefficients(WindowKind(window), fft), fft)
    ).to(card)
    coeffs = tuple(float(a) for a in sl._stencil())
    args = (fr, fi, deltas, upd_r, upd_i, rot_r, rot_i, dc, norm)
    kw = dict(n=fft, coeffs=coeffs, floor_db=DB_FLOOR)
    for ready in sorted({0, 1, cols}):
        before = thop.sliding_hop.launches
        kr, ki, kc = thop.sliding_hop(ready, *args, **kw)
        assert thop.sliding_hop.launches == before + 1
        rr, ri, rc = thop.sliding_hop_reference(ready, *args, **kw)
        torch.cuda.synchronize()
        assert kc.dtype == torch.uint16 and kc.shape == rc.shape
        scale = torch.amax(torch.hypot(rr, ri), dim=1, keepdim=True)
        err = torch.maximum((kr - rr).abs(), (ki - ri).abs()) / scale
        assert float(err.max()) <= 1e-5, ready
        ref = rc.to(torch.int32)
        held = ref >= ref.amax(dim=-1, keepdim=True) - RESOLVED_CODES
        assert int(((kc.to(torch.int32) - ref).abs() * held).max()) <= 2, ready
        if ready == 0:
            assert torch.equal(kr, fr) and torch.equal(ki, fi)


@pytest.mark.cuda
def test_sliding_hop_rejects_bad_inputs(card):
    sl = SlidingSTFT(256, 32, 256, WindowKind.HANN)
    rot_r, rot_i, upd_r, upd_i, dc = sl._tensors(card)
    fr = torch.zeros((4, sl.bins), device=card)
    deltas = torch.zeros((4, 8, 32), device=card)
    norm = torch.ones((sl.bins,), device=card)
    kw = dict(n=256, coeffs=(0.5, -0.5), floor_db=DB_FLOOR)
    with pytest.raises(ValueError):  # a CPU tensor among CUDA ones
        thop.sliding_hop(1, fr, fr, deltas.cpu(), upd_r, upd_i, rot_r, rot_i, dc, norm, **kw)
    with pytest.raises(ValueError):  # not contiguous
        thop.sliding_hop(1, fr, fr, deltas.transpose(1, 2).contiguous().transpose(1, 2),
                         upd_r, upd_i, rot_r, rot_i, dc, norm, **kw)
    with pytest.raises(ValueError):  # a stencil wider than the kernel's halo
        thop.sliding_hop(1, fr, fr, deltas, upd_r, upd_i, rot_r, rot_i, dc, norm,
                         n=256, coeffs=(0.3, 0.2, 0.2, 0.2, 0.1), floor_db=DB_FLOOR)
