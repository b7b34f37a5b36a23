"""Kernel parity between the JAX package and the PyTorch port.

Each port kernel wrapper, called on CPU tensors, computes its plain
PyTorch version; here that version is held against the JAX package's
Pallas kernel run in interpret mode on the same numpy inputs (the flash
backward through ``jax.vjp``). (The CUDA
kernels themselves are held against the same plain versions on the
card by ``chip_smoke.py``.) Tolerances: fp32 1e-5 (summation order
only), bf16 2e-2 (a bf16 ulp at |x| <= 2 plus rounding-point drift)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dla_tpu.ops.decode_kernel import flash_decode_attention as j_decode
from dla_tpu.ops.flash_attention import flash_causal_attention as j_flash
from dla_tpu.ops.quant_matmul import int8_matmul as j_int8_matmul
from dla_tpu_torch.ops.decode_kernel import flash_decode_attention
from dla_tpu_torch.ops.flash_attention import (
    delta_rowsum,
    flash_attention_backward,
    flash_attention_forward,
    flash_backward_plain,
    flash_causal_attention,
    flash_forward_plain,
)
from dla_tpu_torch.ops.quant_matmul import int8_matmul

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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


# ------------------------------------------------------------- flash fwd

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    dict(b=2, t=32, h=4, kh=2, bq=8, bk=16),               # GQA
    dict(b=1, t=48, h=2, kh=2, bq=16, bk=8, window=10),    # sliding window
    dict(b=2, t=32, h=4, kh=1, bq=16, bk=16, segments=True),  # packing
])
def test_flash_plain_matches_pallas(case, dtype):
    rs = np.random.RandomState(1)
    b, t, h, kh, d = case["b"], case["t"], case["h"], case["kh"], 16
    q, qt = _pair(rs.randn(b, t, h, d), dtype)
    k, kt = _pair(rs.randn(b, t, kh, d), dtype)
    v, vt = _pair(rs.randn(b, t, kh, d), dtype)
    seg = None
    if case.get("segments"):
        seg = np.zeros((b, t), np.int32)
        seg[0, :12], seg[0, 12:27] = 1, 2           # two segments + pads
        seg[1, :30] = 1
    ref = j_flash(q, k, v, segment_ids=None if seg is None
                  else jnp.asarray(seg),
                  block_q=case["bq"], block_k=case["bk"], interpret=True,
                  window=case.get("window"))
    out = flash_causal_attention(
        qt, kt, vt, window=case.get("window"),
        segment_ids=None if seg is None else torch.from_numpy(seg))
    assert out.dtype == qt.dtype and out.shape == (b, t, h, d)
    np.testing.assert_allclose(_np(out), _np(ref), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_flash_plain_lse_and_masked_rows():
    """lse is log-sum-exp of each scaled, masked score row; a query whose
    segment matches no key (segment ids differ on the q and kv side) is
    fully masked -> zero output, lse -1e30, no NaN."""
    rs = np.random.RandomState(2)
    b, t, h, d = 1, 8, 2, 16
    q = torch.from_numpy(rs.randn(b, t, h, d).astype(np.float32))
    k = torch.from_numpy(rs.randn(b, t, h, d).astype(np.float32))
    v = torch.from_numpy(rs.randn(b, t, h, d).astype(np.float32))
    qseg = torch.ones((b, t), dtype=torch.int32)
    kseg = torch.ones((b, t), dtype=torch.int32)
    qseg[0, 5] = 7                                  # row 5 matches nothing
    with torch.no_grad():
        out, lse = flash_attention_forward(q, k, v, segment_ids=qseg,
                                           kv_segment_ids=kseg)
    s = torch.einsum("bthd,bshd->bhts", q, k) * d ** -0.5
    causal = torch.ones(t, t).tril().bool()
    want = torch.logsumexp(s.masked_fill(~causal, float("-inf")), -1)
    keep = torch.arange(t) != 5
    np.testing.assert_allclose(lse[0][:, keep].numpy(),
                               want[0][:, keep].numpy(), atol=1e-5)
    assert torch.all(lse[0, :, 5] == -1e30)
    assert torch.all(out[0, 5] == 0) and torch.isfinite(out).all()


# ------------------------------------------------------------- flash bwd

# bf16: dS is rounded to bf16 before its products in both packages, so a
# one-ulp flip of a dS entry near a rounding point moves a gradient by
# ~2^-8 of its scale; 3e-2 at |grad| <= ~4 covers that, fp32 sums only
# differ in order (1e-4).
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    dict(b=2, t=32, h=4, kh=2, bq=8, bk=16),                 # GQA
    dict(b=1, t=48, h=2, kh=2, bq=16, bk=8, window=10),      # window
    dict(b=2, t=32, h=4, kh=1, bq=16, bk=16, segments=True),  # packing
    dict(b=2, t=40, h=4, kh=2, bq=8, bk=8, segments=True),    # ragged T
    # the CUDA kernels' head dims at blocks of 64 (below 128 the Pallas
    # wrapper takes only blocks that divide T), and D=128 over 3 blocks
    dict(b=2, t=64, h=4, kh=2, bq=64, bk=64, d=64, segments=True),
    dict(b=1, t=64, h=4, kh=1, bq=64, bk=64, d=96, window=20),
    dict(b=1, t=64, h=2, kh=2, bq=64, bk=64, d=128),
    dict(b=2, t=48, h=4, kh=2, bq=16, bk=16, d=128, segments=True),
])
def test_flash_backward_plain_matches_pallas(case, dtype):
    """dQ, dK, dV of ``flash_backward_plain`` (what the autograd Function
    runs on CPU tensors) against ``jax.vjp`` of the Pallas flash
    attention (its two backward kernels, interpret mode) for the same
    cotangent."""
    import jax
    rs = np.random.RandomState(6)
    b, t, h, kh = case["b"], case["t"], case["h"], case["kh"]
    d = case.get("d", 16)
    q, qt = _pair(rs.randn(b, t, h, d), dtype)
    k, kt = _pair(rs.randn(b, t, kh, d), dtype)
    v, vt = _pair(rs.randn(b, t, kh, d), dtype)
    g, gt = _pair(rs.randn(b, t, h, d), dtype)
    seg = None
    if case.get("segments"):
        seg = np.zeros((b, t), np.int32)
        seg[0, :12], seg[0, 12:27] = 1, 2            # two segments + pads
        seg[1, :t - 2] = 1
    jseg = None if seg is None else jnp.asarray(seg)
    tseg = None if seg is None else torch.from_numpy(seg)

    def f(q, k, v):
        return j_flash(q, k, v, segment_ids=jseg, block_q=case["bq"],
                       block_k=case["bk"], interpret=True,
                       window=case.get("window"))
    _, vjp = jax.vjp(f, q, k, v)
    refs = vjp(g)
    out, lse = flash_attention_forward(qt, kt, vt, segment_ids=tseg,
                                       window=case.get("window"))
    grads = flash_backward_plain(qt, kt, vt, out, lse, gt, segment_ids=tseg,
                                 window=case.get("window"))
    for got, ref, x in zip(grads, refs, (qt, kt, vt)):
        assert got.dtype == x.dtype and got.shape == x.shape
        np.testing.assert_allclose(_np(got), _np(ref), atol=BWD_TOL[dtype],
                                   rtol=BWD_TOL[dtype])


@pytest.mark.parametrize("case", [
    dict(kh=2),
    dict(kh=1, window=5),
    dict(kh=2, segments=True),
])
def test_flash_autograd_matches_autograd_of_plain_forward(case):
    """The autograd Function's backward (the plain backward on CPU
    tensors) equals torch.autograd through ``flash_forward_plain``, fp32:
    summation order only (1e-5)."""
    rs = np.random.RandomState(7)
    b, t, h, d = 2, 24, 4, 8
    mk = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    q, k, v = mk(b, t, h, d), mk(b, t, case["kh"], d), mk(b, t, case["kh"], d)
    g = mk(b, t, h, d)
    seg = None
    if case.get("segments"):
        seg = torch.ones((b, t), dtype=torch.int32)
        seg[:, 10:] = 2
        seg[1, 20:] = 0
    kw = dict(segment_ids=seg, window=case.get("window"))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_causal_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, g)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref_out, _ = flash_forward_plain(*leaves, **kw)
    want = torch.autograd.grad(ref_out, leaves, g)
    np.testing.assert_allclose(out.detach().numpy(),
                               ref_out.detach().numpy(), atol=1e-6)
    for a, r in zip(got, want):
        np.testing.assert_allclose(a.numpy(), r.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_flash_backward_dq_interface_on_cpu():
    """On CPU tensors ``flash_attention_backward`` is
    ``flash_backward_plain``, and ``delta_rowsum`` (the plain version of
    the delta the dQ kernel writes on the card for the dK/dV kernel) is
    rowsum(dout * out) as a [B, H, T] fp32 tensor."""
    rs = np.random.RandomState(8)
    b, t, h, kh, d = 2, 20, 4, 2, 8
    mk = lambda *s: torch.from_numpy(rs.randn(*s).astype(np.float32))
    q, k, v, g = mk(b, t, h, d), mk(b, t, kh, d), mk(b, t, kh, d), \
        mk(b, t, h, d)
    seg = torch.ones((b, t), dtype=torch.int32)
    seg[:, 12:] = 2
    out, lse = flash_attention_forward(q, k, v, segment_ids=seg, window=9)
    kw = dict(segment_ids=seg, window=9)
    got = flash_attention_backward(q, k, v, out, lse, g, **kw)
    want = flash_backward_plain(q, k, v, out, lse, g, **kw)
    for a, r in zip(got, want):
        assert torch.equal(a, r)
    delta = delta_rowsum(out, g)
    assert delta.shape == (b, h, t) and delta.dtype == torch.float32
    np.testing.assert_allclose(
        delta.numpy(), np.einsum("bthd,bthd->bht", out.numpy(), g.numpy()),
        atol=1e-5)


def _code_of(path) -> str:
    """A CUDA source without its comments."""
    import re
    text = path.read_text()
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def test_flash_backward_kernels_use_no_atomics():
    """The backward kernels own each output tile in one block and sum in a
    fixed order, so gradients are bit-identical from run to run (the
    resume check of chip_smoke.py's train phase relies on it): no atomic
    or reduction instruction in the source or the header it includes."""
    import re
    from pathlib import Path
    csrc = Path(__file__).resolve().parents[1] / "dla_tpu_torch" / "csrc"
    for name in ("flash_bwd.cu", "hopper.cuh"):
        code = _code_of(csrc / name)
        assert "flash_bwd_dq_kernel" in code or name != "flash_bwd.cu"
        found = re.findall(r"\batomic\w*|\batom\.\w*|\bred\.\w*|"
                           r"cp\.reduce\.\w*", code)
        assert not found, (name, found)


# ------------------------------------------------------- decode attention

def _sym_int8(x: np.ndarray):
    sc = np.abs(x).max(-1) / 127.0 + 1e-12
    q = np.clip(np.round(x / sc[..., None]), -127, 127).astype(np.int8)
    return q, sc.astype(np.float32)


@pytest.mark.parametrize("case", [
    dict(cache="bfloat16"),
    dict(cache="int8"),
    dict(cache="int8", fill=150, poison=True),   # NaN past the fill level
    dict(cache="bfloat16", fill=70, poison=True),
    dict(cache="int8", softcap=30.0),
    dict(cache="bfloat16", masked_row=True),     # row 0 attends only itself
    # the fill as a 0-dim int32 tensor (the decode step's device column)
    dict(cache="int8", fill=150, poison=True, fill_tensor=True),
    dict(cache="bfloat16", fill=70, poison=True, fill_tensor=True),
    dict(cache="int8", fill=0, fill_tensor=True),  # only the new column
])
def test_decode_plain_matches_pallas(case):
    rs = np.random.RandomState(3)
    b, s, h, kh, d = 2, 200, 8, 4, 128
    q, qt = _pair(rs.randn(b, 1, h, d), "bfloat16")
    kn, knt = _pair(rs.randn(b, 1, kh, d), "bfloat16")
    vn, vnt = _pair(rs.randn(b, 1, kh, d), "bfloat16")
    fill = case.get("fill")
    valid = rs.rand(b, s) < 0.8
    if fill is not None:
        valid &= np.arange(s)[None, :] < fill
    if case.get("masked_row"):
        valid[0] = False
    qpos = np.full((b, 1), s, np.int32)
    kpos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    kc_f, vc_f = rs.randn(b, s, kh, d), rs.randn(b, s, kh, d)
    kw_j, kw_t = {}, {}
    if case["cache"] == "int8":
        kq, ksc = _sym_int8(kc_f)
        vq, vsc = _sym_int8(vc_f)
        ksc, vsc = ksc.transpose(0, 2, 1).copy(), vsc.transpose(0, 2, 1).copy()
        if case.get("poison"):     # scales past the fill may hold garbage
            ksc[:, :, fill:] = np.nan
            vsc[:, :, fill:] = np.nan
        kc, kct = jnp.asarray(kq), torch.from_numpy(kq)
        vc, vct = jnp.asarray(vq), torch.from_numpy(vq)
        kw_j = dict(k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc))
        kw_t = dict(k_scale=torch.from_numpy(ksc),
                    v_scale=torch.from_numpy(vsc))
    else:
        if case.get("poison"):
            kc_f[:, fill:] = np.nan
            vc_f[:, fill:] = np.nan
        kc, kct = _pair(kc_f, "bfloat16")
        vc, vct = _pair(vc_f, "bfloat16")
    cap = case.get("softcap", 0.0)
    ref = j_decode(q, kc, vc, kn, vn, kv_valid=jnp.asarray(valid),
                   q_positions=jnp.asarray(qpos),
                   kv_positions=jnp.asarray(kpos), logit_softcap=cap,
                   kv_fill=None if fill is None else jnp.asarray(fill),
                   block_s=128, interpret=True, **kw_j)
    call = dict(kv_valid=torch.from_numpy(valid),
                q_positions=torch.from_numpy(qpos),
                kv_positions=torch.from_numpy(kpos.copy()),
                logit_softcap=cap, **kw_t)
    out = flash_decode_attention(qt, kct, vct, knt, vnt, kv_fill=fill,
                                 **call)
    if case.get("fill_tensor"):   # the device-scalar form, same result
        host = out
        out = flash_decode_attention(
            qt, kct, vct, knt, vnt,
            kv_fill=torch.tensor(fill, dtype=torch.int32), **call)
        assert torch.equal(out, host)
    assert out.dtype == torch.bfloat16 and out.shape == (b, 1, h, d)
    assert torch.isfinite(out.float()).all()
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-2, rtol=2e-2)
    if case.get("masked_row"):     # only the new token: out == v_new
        want = np.repeat(_np(vnt)[0, 0], h // kh, axis=0)
        np.testing.assert_allclose(_np(out)[0, 0], want, atol=1e-2)


# --------------------------------------------------------- int8 matmul

@pytest.mark.parametrize("m,k,n", [(3, 64, 208), (130, 128, 384),
                                   (5, 96, 48), (64, 256, 1040)])
def test_int8_matmul_plain_matches_pallas(m, k, n):
    """Ragged M and N (not multiples of the 64-wide CUDA tile or the
    TPU's 128 lanes); the two agree exactly — same bf16 operands, fp32
    sums, one rounding — so the bound is a single bf16 ulp."""
    rs = np.random.RandomState(4)
    w = rs.randn(k, n).astype(np.float32) * 0.02
    sc = (np.abs(w).max(0) / 127 + 1e-12).astype(np.float32)
    q = np.clip(np.round(w / sc), -127, 127).astype(np.int8)
    x = rs.randn(m, k).astype(np.float32)
    ref = j_int8_matmul(jnp.asarray(x), jnp.asarray(q),
                        jnp.asarray(sc[None]), interpret=True)
    out = int8_matmul(torch.from_numpy(x), torch.from_numpy(q),
                      torch.from_numpy(sc))
    assert out.dtype == torch.bfloat16 and out.shape == (m, n)
    np.testing.assert_allclose(_np(out), _np(ref), atol=2e-2, rtol=2e-2)


def test_int8_matmul_leading_dims_and_scale_shapes():
    rs = np.random.RandomState(5)
    q = torch.from_numpy(rs.randint(-127, 128, (32, 48)).astype(np.int8))
    sc = torch.from_numpy(rs.rand(48).astype(np.float32) * 1e-2)
    x = torch.from_numpy(rs.randn(2, 3, 32).astype(np.float32))
    out = int8_matmul(x, q, sc)
    assert out.shape == (2, 3, 48)
    flat = int8_matmul(x.reshape(6, 32), q, sc[None, :]).reshape(2, 3, 48)
    assert torch.equal(out, flat)
    with pytest.raises(ValueError):
        int8_matmul(x, q.float(), sc)
