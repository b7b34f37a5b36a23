"""The Hopper int8 matmul and flash forward: their plain versions at the
new kernels' edge shapes, the int8 wrapper's kernel planner, and the
sources' structure.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against these plain versions there); here the wrappers, given CPU
tensors, compute the plain versions, which are held against the JAX
package's Pallas kernels in interpret mode on the same numpy inputs.
Nothing here touches CUDA, the compiler or the kernel library.
Tolerances: fp32 1e-5 (summation order only), bf16 2e-2 (a bf16 ulp at
|x| <= 2 plus rounding-point drift)."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.ops.flash_attention import flash_causal_attention as j_flash
from dla_tpu.ops.quant_matmul import int8_matmul as j_int8_matmul
from dla_tpu_torch.ops.flash_attention import (
    flash_attention_forward,
    flash_causal_attention,
    flash_forward_plain,
)
from dla_tpu_torch.ops.quant_matmul import (
    int8_matmul,
    int8_matmul_plain,
    plan,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CSRC = Path(__file__).resolve().parents[1] / "dla_tpu_torch" / "csrc"
H100_SMS = 132

# llama3-8b's projections (K, N) and lm_head: the rollout path's shapes
PROJ = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
        (4096, 128256)]


def _pair(x: np.ndarray, dtype: str):
    """(jax array, torch tensor) of the same values in ``dtype``."""
    j = jnp.asarray(x, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# --------------------------------------------------------- int8 matmul

@pytest.mark.parametrize("m,k,n", [
    (129, 72, 272),    # one row past a 128-row tile, K and N ragged
    (128, 64, 256),    # exactly one 128 x 256 tile, one 64-deep stage
    (257, 136, 528),   # two full M tiles + 1 row, N past 2 x 256
])
def test_int8_matmul_plain_matches_pallas_at_tile_edges(m, k, n):
    """The TMA kernel's 128 x 256 tiles and 64-deep stages
    do not divide these shapes (K % 8 == 0 and N % 16 == 0, as the
    kernel requires); the plain version agrees with the Pallas kernel to
    a bf16 ulp — same bf16 operands, fp32 sums, one rounding."""
    rs = np.random.RandomState(11)
    w = rs.randn(k, n).astype(np.float32) * 0.02
    sc = (np.abs(w).max(0) / 127 + 1e-12).astype(np.float32)
    q = np.clip(np.round(w / sc), -127, 127).astype(np.int8)
    x = rs.randn(m, k).astype(np.float32)
    ref = j_int8_matmul(jnp.asarray(x), jnp.asarray(q),
                        jnp.asarray(sc[None]), interpret=True)
    out = int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                      torch.from_numpy(sc))
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    assert torch.equal(out, int8_matmul_plain(
        torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(sc)))
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("sms", [1, 114, H100_SMS])
def test_int8_plan_covers_every_m(sms):
    """Every M >= 1 gets a plan with a known path: the TMA path (one
    split, 256-column tiles, rows past M read as zeros) exactly from
    M = 65, up to the decode batch of 64 the decode
    kernel at 128 or 64 columns with a power-of-two count of K splits,
    at most the cluster limit of its width and never more than the K
    tiles (no empty split)."""
    for k, n in PROJ + [(8, 16), (72, 272), (64, 48)]:
        k_tiles = -(-k // 64)
        for m in list(range(1, 300)) + [511, 512, 4096, 8190, 8192, 65536]:
            p = plan(m, n, k, sms)
            assert p.path == ("tma" if m > 64 else "decode"), (m, n, k, p)
            if p.path == "tma":
                assert (p.splits, p.tile_n) == (1, 256)
                continue
            assert p.tile_n in (64, 128), p
            assert p.splits & (p.splits - 1) == 0, p
            assert 1 <= p.splits <= min(k_tiles, 4 if p.tile_n == 128
                                        else 16), (m, n, k, p)
            # each split's run of K tiles (the kernel's balanced cut)
            runs = [(z + 1) * k_tiles // p.splits - z * k_tiles // p.splits
                    for z in range(p.splits)]
            assert min(runs) >= 1, (m, n, k, p, runs)


@pytest.mark.parametrize("k,n", PROJ)
def test_int8_plan_rollout_shapes(k, n):
    """Decode (M = batch 64, and the M = 1 edge) takes the cluster
    split-K decode kernel with at least one block on every SM of an H100
    for every projection and lm_head; a prefill (M = 64 x 128 = 8192),
    and any M past the decode batch (65, 127), takes the TMA + wgmma
    kernel, whose 128 x 256 tiles give enough blocks for every SM at
    each projection of the prefill."""
    for m in (1, 64):
        dec = plan(m, n, k, H100_SMS)
        assert dec.path == "decode"
        assert -(-n // dec.tile_n) * dec.splits >= H100_SMS, (m, k, n, dec)
        assert dec.splits <= -(-k // 64)
    for m in (65, 127, 8192):
        assert plan(m, n, k, H100_SMS) == ("tma", 1, 256)
    assert -(-8192 // 128) * -(-n // 256) >= H100_SMS


def test_int8_plan_splitk_splits():
    """The decode kernel takes the widest block whose tiles, K split in
    powers of two up to its cluster limit (4 at 128 columns, 16 at 64),
    fill the card, splitting no more than needed: 128-column blocks for
    lm_head and gate/up, 64-column blocks for the 4096- and 1024-wide
    projections; a short K caps the splits at its K tiles."""
    assert plan(64, 128256, 4096, H100_SMS) == ("decode", 1, 128)
    assert plan(64, 14336, 4096, H100_SMS) == ("decode", 2, 128)
    assert plan(64, 4096, 4096, H100_SMS) == ("decode", 4, 64)
    assert plan(64, 4096, 14336, H100_SMS) == ("decode", 4, 64)
    assert plan(64, 1024, 4096, H100_SMS) == ("decode", 16, 64)
    assert plan(1, 16, 8, H100_SMS) == ("decode", 1, 64)
    assert plan(64, 1024, 256, H100_SMS) == ("decode", 4, 64)  # 4 K tiles
    assert plan(33, 128 * H100_SMS, 4096, H100_SMS) == ("decode", 1, 128)


# --------------------------------------------------------- flash forward

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    dict(b=2, t=96, h=2, kh=1, d=64, window=40),    # SFT head dim, g=2
    dict(b=1, t=96, h=4, kh=1, d=128, window=33),   # rollout head dim, g=4
])
def test_flash_plain_matches_pallas_segments_window(case, dtype):
    """T = 96 (not a multiple of the kernel's 128-row tiles), GQA, packed
    segment ids with padding, and a sliding window, at the head dims the
    kernel instantiates: ``flash_causal_attention`` on CPU tensors (the
    plain forward) against the Pallas forward in interpret mode."""
    rs = np.random.RandomState(12)
    b, t, h, kh, d = case["b"], case["t"], case["h"], case["kh"], case["d"]
    q, qt = _pair(rs.randn(b, t, h, d), dtype)
    k, kt = _pair(rs.randn(b, t, kh, d), dtype)
    v, vt = _pair(rs.randn(b, t, kh, d), dtype)
    seg = np.zeros((b, t), np.int32)
    seg[0, :20], seg[0, 20:61], seg[0, 61:90] = 1, 2, 3   # + 6 pads
    if b > 1:
        seg[1, :77] = 1
    ref = j_flash(q, k, v, segment_ids=jnp.asarray(seg), block_q=48,
                  block_k=48, interpret=True, window=case["window"])
    out = flash_causal_attention(qt, kt, vt, window=case["window"],
                                 segment_ids=torch.from_numpy(seg))
    assert out.dtype == qt.dtype and out.shape == (b, t, h, d)
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_flash_forward_lse_layout_for_the_backward():
    """The forward's lse stays [B, H, T] fp32 natural-log, one value per
    query row, -1e30 on a row with no live key (what the backward kernels
    read), at T = 130 with a window and segments."""
    rs = np.random.RandomState(13)
    b, t, h, kh, d = 1, 130, 4, 2, 64
    q = torch.from_numpy(rs.randn(b, t, h, d).astype(np.float32))
    k = torch.from_numpy(rs.randn(b, t, kh, d).astype(np.float32))
    v = torch.from_numpy(rs.randn(b, t, kh, d).astype(np.float32))
    qseg = torch.ones((b, t), dtype=torch.int32)
    kseg = torch.ones((b, t), dtype=torch.int32)
    qseg[0, 100] = 9                           # matches no key
    out, lse = flash_attention_forward(q, k, v, segment_ids=qseg,
                                       kv_segment_ids=kseg, window=17)
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    s = torch.einsum("bthd,bshd->bhts", q, k.repeat_interleave(2, 2))
    s = s * d ** -0.5
    pos = torch.arange(t)
    live = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < 17)
    want = torch.logsumexp(s.masked_fill(~live, float("-inf")), -1)
    keep = pos != 100
    np.testing.assert_allclose(lse[0][:, keep].numpy(),
                               want[0][:, keep].numpy(), atol=1e-5)
    assert torch.all(lse[0, :, 100] == -1e30)
    assert torch.all(out[0, 100] == 0)
    ref, ref_lse = flash_forward_plain(q, k, v, segment_ids=qseg,
                                       kv_segment_ids=kseg, window=17)
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


# ------------------------------------------------------------- sources

def _code_of(path) -> str:
    """A CUDA source without its comments."""
    text = path.read_text()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


@pytest.mark.parametrize("name", ["int8_matmul.cu", "flash_fwd.cu",
                                  "hopper.cuh", "decode_attn.cu"])
def test_hopper_kernels_use_no_atomics(name):
    """Each output element has one owner that sums in a fixed order, so
    the rollout and SFT paths are bit-stable from run to run: no atomic
    or reduction instruction in the sources."""
    code = _code_of(CSRC / name)
    found = re.findall(r"\batomic\w*|\batom\.\w*|\bred\.\w*|"
                       r"cp\.reduce\.\w*", code)
    assert not found, (name, found)


@pytest.mark.parametrize("name,kernel", [
    ("int8_matmul.cu", "int8_mm_tma_kernel"),
    ("int8_matmul.cu", "int8_mm_decode_kernel"),
    ("flash_fwd.cu", "flash_fwd_kernel"),
])
def test_hopper_kernels_use_tma_ring_and_wgmma(name, kernel):
    """The redesigned kernels load through TMA into an mbarrier ring and
    multiply with wgmma, and call no library kernel; the prefill kernels
    rebalance registers with setmaxnreg, the decode matmul sums its K
    splits inside a cluster."""
    code = _code_of(CSRC / name)
    assert f"{kernel}(" in code
    extra = "cluster_sync" if kernel == "int8_mm_decode_kernel" \
        else "setmaxnreg_"
    for needed in ("tma_load_", "mbar_wait", "mbar_arrive", "wgmma_",
                   extra):
        assert needed in code, (name, needed)
    for banned in ("cublas", "cudnn", "cutlass::gemm"):
        assert banned not in code.lower(), (name, banned)


def test_decode_attention_source_one_launch_fixed_grid():
    """Decode attention is one kernel whose grid is (batch x kv heads,
    split), read from the shapes only: the fill comes from a device
    scalar inside the kernel, so a CUDA graph of the decode step replays
    it at every fill. The two-kernel split-S design with its fp32
    workspace is gone."""
    code = _code_of(CSRC / "decode_attn.cu")
    assert code.count("__global__") == 1
    assert "decode_attn_kernel(" in code
    assert "dim3(pairs, split, 1)" in code
    assert "fill_dev" in code and "*a.fill_dev" in code
    for gone in ("decode_chunk_kernel", "decode_merge_kernel", "ws"):
        assert not re.search(rf"\b{gone}\b", code), gone
    for needed in ("cp_async16", "mma_16816", "ldsm_x4_trans",
                   "cluster_sync"):
        assert needed in code, needed
