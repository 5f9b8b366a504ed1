"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: without CUDA every test skips (the kernels have no CPU mode;
the CPU parity tests hold the plain versions to the JAX package). Run on a
machine with an H100 and nvcc, without the JAX conftest:
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q``.

Tolerances: bf16 outputs from fp32 sums in another order than the plain
versions may differ by about one bf16 ulp (2^-8 relative), and near-zero
elements get an absolute floor; fp32 outputs (the default compute dtype)
differ only by the order of fp32 sums (RTOL_F32, ATOL_F32).

The entry points' default-dtype tests (``test_*_default_dtype``) run a path
twice on the card: through the kernels, then with every kernel wrapper of
the path replaced by its plain version (``plain_kernels``).
"""
import pytest
import torch

from slime_tpu_torch.models import layers as L
from slime_tpu_torch.models.layers import fp32_accumulation
from slime_tpu_torch.ops import _cuda
from slime_tpu_torch.ops import encoder_attention as ea
from slime_tpu_torch.ops import flash_attention as fa
from slime_tpu_torch.ops import fused_mlp, fused_qkvo
from slime_tpu_torch.ops import quant_matmul as qm
from slime_tpu_torch.ops import quantization as quant
from slime_tpu_torch.ops import w8a8_matmul as w8
from slime_tpu_torch.ops import weight_ring as wr

pytestmark = pytest.mark.gpu
RTOL = 2 ** -7
RTOL_F32, ATOL_F32 = 1e-5, 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    with fp32_accumulation():         # the plain versions' matmuls, as generate runs them
        yield torch.device("cuda")


def _assert_close(got, want, atol, rtol=RTOL):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def plain_kernels(monkeypatch):
    """Replace every kernel wrapper of the serving and training paths by its
    plain version, where the path looks it up: the same path then runs in
    plain torch on the card."""
    from slime_tpu_torch.models import llama
    monkeypatch.setattr(llama, "fused_qkv_decode", fused_qkvo.fused_qkv_decode_ref)
    monkeypatch.setattr(llama, "fused_o_residual", fused_qkvo.fused_o_residual_ref)
    monkeypatch.setattr(llama, "fused_mlp_decode", fused_mlp.fused_mlp_decode_ref)
    monkeypatch.setattr(L, "quant_matmul", qm.quant_matmul_ref)
    monkeypatch.setattr(L, "quant_matmul_q4g", qm.quant_matmul_q4g_ref)
    monkeypatch.setattr(w8, "w8a8_matmul", w8.w8a8_matmul_ref)
    monkeypatch.setattr(ea, "encoder_attention_kernel",
                        lambda q, k, v, *, scale, variant=0: ea.encoder_attention_ref(
                            q, k, v, scale=scale))
    monkeypatch.setattr(fa, "flash_fwd", fa.flash_fwd_ref)
    monkeypatch.setattr(fa, "flash_bwd_dkdv", fa.flash_bwd_dkdv_ref)
    monkeypatch.setattr(fa, "flash_bwd_dq", fa.flash_bwd_dq_ref)


def _assert_mlp_close(got, want, floor):
    """|got - want| <= RTOL |want| + floor + 1e-6, elementwise; ``floor`` is
    the one-ulp bound of the MLP's bf16 intermediate a = bf16(silu(g) u)
    (``fused_mlp.intermediate_ulp_bound``): where the kernel and the plain
    version round an element of a to neighbouring bf16 values, the output
    moves by that element's ulp times its down-projection weight."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    slack = RTOL * want.float().abs() + floor + 1e-6
    assert bool((err <= slack).all()), (
        f"MLP: max err {err.max().item():.3g}, worst excess "
        f"{(err - slack).max().item():.3g} over the one-ulp floor")


def decode_layers(*, L, H, NQ, NKV, I, fmt, generator, device):
    """Random stacked decode weights: int8 per-row (scales ~ N(0, 0.02)
    rows, as bench.py builds them), q4g (N(0, 0.02) weights quantized) or
    dense bf16 ("bf16") or fp32 ("fp32")."""
    def proj(out_d, in_d):
        if fmt == "q4g":
            w = torch.randn((L, out_d, in_d), device=device, generator=generator) * 0.02
            return {"weight": quant.quantize_weight_q4g(w)}
        if fmt == "int8":
            q = torch.randint(-127, 128, (L, out_d, in_d), dtype=torch.int8,
                              device=device, generator=generator)
            return {"weight": {"q": q, "scale": torch.full(
                (L, out_d, 1), 0.02 / 127.0, device=device)}}
        w = torch.randn((L, out_d, in_d), device=device, generator=generator) * 0.02
        return {"weight": w if fmt == "fp32" else w.to(torch.bfloat16)}

    def norm():
        return {"weight": 1 + 0.1 * torch.randn((L, H), device=device,
                                                generator=generator)}
    return {"input_layernorm": norm(), "post_attention_layernorm": norm(),
            "q_proj": proj(NQ, H), "k_proj": proj(NKV, H), "v_proj": proj(NKV, H),
            "o_proj": proj(H, NQ), "gate_proj": proj(I, H), "up_proj": proj(I, H),
            "down_proj": proj(H, I)}


def test_hopper_selftest(dev):
    """The wgmma tile vocabulary (hopper_common.cuh) against torch.matmul:
    TMA loads with the 128-byte swizzle, SS wgmma (S = A.B^T, K-major), the
    accumulator as P's register fragments, RS wgmma with V MN-major over two
    64-column chunks. Small integers keep every sum exact in fp32, so both
    must agree bit for bit."""
    g = torch.Generator(device=dev).manual_seed(0)
    a, b = (torch.randint(-3, 4, (64, 64), device=dev, generator=g).to(torch.bfloat16)
            for _ in range(2))
    v = torch.randint(-3, 4, (64, 128), device=dev, generator=g).to(torch.bfloat16)
    s, o, t, p1, p2 = _cuda.hopper_selftest(a, b, v)
    want_s = torch.matmul(a.float(), b.float().T)
    want_t = torch.matmul(b.float(), a.float().T)
    rs, rt = want_s.to(torch.bfloat16).float(), want_t.to(torch.bfloat16).float()
    _assert_close(s, want_s, atol=0, rtol=0)
    _assert_close(t, want_t, atol=0, rtol=0)
    _assert_close(o, torch.matmul(rs, v.float()), atol=0, rtol=0)
    _assert_close(p1, torch.matmul(rs, b.float()), atol=0, rtol=0)
    _assert_close(p2, torch.matmul(rt, a.float()), atol=0, rtol=0)


def test_hopper_selftest_s8(dev):
    """The int8 form of P3's and K8's main loop (hopper_common.cuh's
    wgmma_s8): int8 tiles by TMA in 128-byte boxes over two K chunks, SS
    s8 wgmma at N = 128 and 256, against the exact integer product, bit for
    bit, over the full int8 range."""
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randint(-128, 128, (64, 256), dtype=torch.int8, device=dev, generator=g)
    b = torch.randint(-128, 128, (256, 256), dtype=torch.int8, device=dev, generator=g)
    c128, c256 = _cuda.hopper_selftest_s8(a, b)
    want = torch.matmul(a.double(), b.double().T).to(torch.int32)
    torch.cuda.synchronize()
    assert torch.equal(c256, want)
    assert torch.equal(c128, want[:, :128])


def test_bulk_copy_selftest(dev):
    """The 1-D bulk copy of K1's weight ring (hopper_common.cuh bulk_load):
    two copies of ragged sizes (multiples of 16 bytes, not powers of two)
    from a source 16- but not 128-byte aligned, onto one mbarrier, come back
    byte for byte; a size that is not a multiple of 16 is refused."""
    g = torch.Generator(device=dev).manual_seed(0)
    src = torch.randint(0, 256, (48 + 4800 + 9584,), dtype=torch.uint8, device=dev,
                        generator=g)
    got = _cuda.bulk_selftest(src[48:], 4800, 9584)
    torch.cuda.synchronize()
    assert torch.equal(got, src[48:])
    with pytest.raises(ValueError):
        _cuda.bulk_selftest(src[48:], 4808 - 1, 9584)


# (B, S, H, D): CLIP-L's shape, then S from one key to the kernel's 1024 at
# head dims 40 (padded by the TMA box), 64 and 128
ENC_SHAPES = [(8, 577, 16, 64), (2, 100, 4, 128), (1, 64, 2, 40)] + [
    (2, S, 3, D) for S in (1, 64, 100, 577, 1024) for D in (40, 64, 128)]


@pytest.mark.parametrize("shape", ENC_SHAPES)
def test_encoder_attention_kernel(dev, shape):
    """K4 itself at every S it takes (JAX's rule routes S = 1024 to the plain
    attention, so the kernel is called directly; test_encoder_attention_rule
    holds the routing)."""
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
               for _ in range(3))
    before = ea.encoder_attention.launches
    out = ea.encoder_attention_kernel(q, k, v, scale=shape[-1] ** -0.5)
    assert ea.encoder_attention.launches == before + 1
    _assert_close(out, ea.encoder_attention_ref(q, k, v), atol=2e-3)


@pytest.mark.parametrize("shape", [(8, 577, 16, 64), (1, 64, 2, 40)] + [
    (2, S, 3, D) for S in (1, 100, 577, 1024) for D in (64, 128)])
def test_encoder_attention_kernel_fp32(dev, shape):
    """The fp32 K4 (FFMA) against the plain version in fp32: the same
    roundings (bf16 clamped scores, l rounded to bf16), sums in another
    order."""
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(shape, device=dev, generator=g) for _ in range(3))
    before = (ea.encoder_attention.launches, ea.encoder_attention.f32_launches)
    out = ea.encoder_attention_kernel(q, k, v, scale=shape[-1] ** -0.5)
    assert out.dtype == torch.float32
    assert (ea.encoder_attention.launches, ea.encoder_attention.f32_launches) == (
        before[0] + 1, before[1] + 1)
    # l = bf16(sum p): fp32 sums in another order can round l to the
    # neighbouring bf16 value, which moves a whole row by 2^-8 relative
    _assert_close(out, ea.encoder_attention_ref(q, k, v), atol=ATOL_F32, rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_encoder_attention_rule(dev, dtype):
    """JAX's rule on the card: shapes it sends to _xla_attention (S > 1024,
    D > 128, D % 8, or the TPU kernel's VMEM estimate over budget) take
    stable_attention and launch nothing; CLIP-L's shape launches K4."""
    g = torch.Generator(device=dev).manual_seed(2)
    for shape, launched in (((2, 577, 16, 64), 1), ((1, 1025, 2, 64), 0), ((1, 64, 2, 136), 0),
                            ((1, 64, 2, 20), 0), ((1, 1024, 2, 64), 0)):
        q, k, v = (torch.randn(shape, device=dev, generator=g).to(dtype) for _ in range(3))
        assert ea.takes_kernel(shape) == bool(launched)
        before = ea.encoder_attention.launches
        out = ea.encoder_attention(q, k, v)
        assert ea.encoder_attention.launches == before + launched
        want = (ea.encoder_attention_ref(q, k, v) if launched
                else ea.stable_attention(q, k, v, scale=shape[-1] ** -0.5))
        _assert_close(out, want, atol=2e-3 if dtype == torch.bfloat16 else ATOL_F32)


def test_encoder_attention_kernel_strided(dev):
    """q/k/v as views of one packed projection, as a packed qkv linear gives."""
    g = torch.Generator(device=dev).manual_seed(1)
    qkv = torch.randn((2, 577, 3 * 16 * 64), device=dev, generator=g).to(torch.bfloat16)
    q, k, v = (t.reshape(2, 577, 16, 64) for t in qkv.split(16 * 64, dim=-1))
    assert not q.is_contiguous()
    _assert_close(ea.encoder_attention(q, k, v), ea.encoder_attention_ref(q, k, v),
                  atol=2e-3)


def test_encoder_attention_kernel_rejects(dev):
    q = torch.zeros((1, 1025, 2, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        ea.encoder_attention_kernel(q, q, q, scale=0.125)
    q = torch.zeros((1, 16, 2, 64), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        ea.encoder_attention(q, q, q)
    with pytest.raises(ValueError):         # the P2 variants are bf16 designs
        ea.encoder_attention_kernel(q.float(), q.float(), q.float(), scale=0.125, variant=1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_take_unaligned_views(dev, dtype):
    """K4 and K5-K5c on views one element off 16 bytes (TMA cannot read
    them): the wrappers copy each into a fresh tensor and launch the same
    kernel (the counts move), and the outputs, and K5's gradients through
    autograd, equal the plain versions on the caller's views."""
    from slime_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(21)
    atol = 2e-3 if dtype == torch.bfloat16 else ATOL_F32
    qkv = torch.randn(2 * 64 * 3 * 2 * 64 + 8, device=dev, generator=g).to(dtype)[1:]
    q, k, v = (t.reshape(2, 64, 2, 64) for t in
               qkv[:2 * 64 * 3 * 2 * 64].view(2, 64, 3 * 2 * 64).split(2 * 64, dim=-1))
    assert not _cuda.tma_ready(q)
    before = ea.encoder_attention.launches
    _assert_close(ea.encoder_attention(q, k, v), ea.encoder_attention_ref(q, k, v), atol=atol)
    assert ea.encoder_attention.launches == before + 1
    B, S, H, KVH, D = 1, 384, 4, 2, 128
    flat = torch.randn(B * S * (H + 2 * KVH) * D + 8, device=dev, generator=g).to(dtype)[1:]
    proj = flat[:B * S * (H + 2 * KVH) * D].view(B, S, (H + 2 * KVH) * D)
    q, k, v = (t.reshape(B, S, -1, D).transpose(1, 2)
               for t in proj.split((H * D, KVH * D, KVH * D), dim=-1))
    do = torch.randn(B * H * S * D + 8, device=dev, generator=g).to(dtype)[1:][
        :B * H * S * D].view(B, H, S, D)
    assert not any(_cuda.tma_ready(t) for t in (q, k, v, do))
    before = (fa.flash_attention.fwd_launches, fa.flash_attention.dkdv_launches,
              fa.flash_attention.dq_launches)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, use_kernel=True)
    out.backward(do)
    assert (fa.flash_attention.fwd_launches, fa.flash_attention.dkdv_launches,
            fa.flash_attention.dq_launches) == tuple(c + 1 for c in before)
    ro, rl = fa.flash_fwd_ref(q, k, v)
    atol = 5e-3 if dtype == torch.bfloat16 else 1e-4
    _assert_close(out.detach(), ro, atol=atol)
    delta = (do.float() * ro.float()).sum(-1)
    for leaf, want in zip(leaves, fa.flash_bwd_ref(q, k, v, do, rl, delta)):
        assert leaf.grad.shape == leaf.shape
        _assert_close(leaf.grad, want, atol=atol)


@pytest.mark.parametrize("variant", sorted(ea.VARIANTS))
def test_encoder_attention_variants(dev, variant):
    """Every design of the P2 probe against the plain version, at CLIP-L's
    shape and a ragged short one."""
    for shape in ((8, 577, 16, 64), (1, 100, 2, 40)):
        g = torch.Generator(device=dev).manual_seed(variant)
        q, k, v = (torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
                   for _ in range(3))
        got = ea.encoder_attention_kernel(q, k, v, scale=shape[-1] ** -0.5, variant=variant)
        _assert_close(got, ea.encoder_attention_ref(q, k, v), atol=2e-3)


# (weight format, activation dtype): dense fp32 weights take fp32 activations
# only (JAX casts them to bf16 for bf16 activations)
DECODE_FORMATS = [(f, torch.bfloat16) for f in ("int8", "bf16", "q4g")] + [
    (f, torch.float32) for f in ("int8", "bf16", "fp32", "q4g")]


@pytest.mark.parametrize("fmt_dtype", DECODE_FORMATS)
@pytest.mark.parametrize("B", [1, 8, 64, 65, 128])
def test_fused_decode_kernels(dev, fmt_dtype, B):
    """K1-K3 at 8B width (H = NQ = 4096, NKV = 1024, I = 14336), layer 1 of 2,
    bf16 and fp32 activations, any B in one launch each."""
    fmt, dtype = fmt_dtype
    g = torch.Generator(device=dev).manual_seed(B)
    layers = decode_layers(L=2, H=4096, NQ=4096, NKV=1024, I=14336, fmt=fmt,
                           generator=g, device=dev)
    x = torch.randn((B, 4096), device=dev, generator=g).to(dtype)
    attn = torch.randn((B, 4096), device=dev, generator=g).to(dtype)
    bf = dtype == torch.bfloat16
    tol = dict(atol=2e-3) if bf else dict(atol=ATOL_F32, rtol=RTOL_F32)
    counts = (fused_qkvo.fused_qkv_decode.launches,
              fused_qkvo.fused_o_residual.launches,
              fused_mlp.fused_mlp_decode.launches, fused_mlp.fused_mlp_decode.f32_launches)
    ring = fused_mlp.fused_mlp_decode.ring_launches
    rings = _ring_counts()
    got = fused_qkvo.fused_qkv_decode(x, layers, 1)
    want = fused_qkvo.fused_qkv_decode_ref(x, layers, 1)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _assert_close(a, b, **tol)
    _assert_close(fused_qkvo.fused_o_residual(attn, x, layers, 1),
                  fused_qkvo.fused_o_residual_ref(attn, x, layers, 1), **tol)
    # the MLP rounds a = silu(g) * u to bf16 before the down projection: held
    # to the one-ulp bound of that rounding (zero in fp32, where a is not
    # rounded)
    got, want = (fused_mlp.fused_mlp_decode(x, layers, 1),
                 fused_mlp.fused_mlp_decode_ref(x, layers, 1))
    if bf:
        _assert_mlp_close(got, want, fused_mlp.intermediate_ulp_bound(x, layers, 1))
    else:
        _assert_close(got, want, **tol)
    assert (fused_qkvo.fused_qkv_decode.launches,
            fused_qkvo.fused_o_residual.launches,
            fused_mlp.fused_mlp_decode.launches, fused_mlp.fused_mlp_decode.f32_launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1, counts[3] + (not bf))
    # the weight ring takes bf16 x with int8 or q4g weights at B <= 8, nothing else
    routed = bf and fmt in ("int8", "q4g") and B <= 8
    assert fused_mlp.fused_mlp_decode.ring_launches == ring + routed
    q4g = fmt == "q4g"
    assert _ring_counts() == tuple(c + routed * (1, q4g)[i % 2] for i, c in enumerate(rings))


def _ring_counts():
    """K2's and K3's (ring, q4g ring) launch counts."""
    return tuple(getattr(fn, a) for fn in (fused_qkvo.fused_qkv_decode,
                                           fused_qkvo.fused_o_residual)
                 for a in ("ring_launches", "q4g_ring_launches"))


def _check_qkvo_ring(x, attn, layers, fmt, ring=True):
    """fused_qkv_decode and fused_o_residual against their plain versions at
    the row-per-warp bf16 instances' atol 2e-3; with ``ring`` each counter
    of the weight ring rises by one, else none does."""
    before = _ring_counts()
    got, want = (fused_qkvo.fused_qkv_decode(x, layers, 1),
                 fused_qkvo.fused_qkv_decode_ref(x, layers, 1))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        _assert_close(a, b, atol=2e-3)
    got = fused_qkvo.fused_o_residual(attn, x, layers, 1)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _assert_close(got, fused_qkvo.fused_o_residual_ref(attn, x, layers, 1), atol=2e-3)
    q4g = fmt == "q4g"
    assert _ring_counts() == tuple(c + ring * (1, q4g)[i % 2] for i, c in enumerate(before))


@pytest.mark.parametrize("fmt", ["int8", "q4g"])
@pytest.mark.parametrize("B", [1, 2, 3, 5, 8])
def test_fused_qkvo_ring_batches(dev, fmt, B):
    """K2 and K3 on the weight ring at 8B width (H = NQ = 4096, NKV = 1024)
    at B between 1 and 8 (the BT = 1, 2, 4, 8 instances, rows unused)."""
    g = torch.Generator(device=dev).manual_seed(200 + B)
    layers = decode_layers(L=2, H=4096, NQ=4096, NKV=1024, I=256, fmt=fmt, generator=g,
                           device=dev)
    x = torch.randn((B, 4096), device=dev, generator=g).to(torch.bfloat16)
    attn = torch.randn((B, 4096), device=dev, generator=g).to(torch.bfloat16)
    _check_qkvo_ring(x, attn, layers, fmt)


# (H, NQ, NKV): row counts ragged against the 132 bands and the stages, and
# stages that meet W_q's or W_k's end (int8 NKV 40 and 136: 8-row stages)
QKVO_RAGGED = {"int8": [(256, 256, 64), (256, 256, 40), (768, 512, 136)],
               "q4g": [(512, 512, 256), (768, 512, 256), (256, 256, 32)]}


@pytest.mark.parametrize("fmt", ["int8", "q4g"])
@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("B", [1, 3, 8])
def test_fused_qkvo_ring_ragged(dev, fmt, case, B):
    H, NQ, NKV = QKVO_RAGGED[fmt][case]
    g = torch.Generator(device=dev).manual_seed(H + NKV + B)
    layers = decode_layers(L=2, H=H, NQ=NQ, NKV=NKV, I=256, fmt=fmt, generator=g,
                           device=dev)
    x = torch.randn((B, H), device=dev, generator=g).to(torch.bfloat16)
    attn = torch.randn((B, NQ), device=dev, generator=g).to(torch.bfloat16)
    _check_qkvo_ring(x, attn, layers, fmt)


@pytest.mark.parametrize("B", [1, 8])
def test_fused_decode_no_ring_plan(dev, B):
    """Layers too wide for the ring's shared memory compute through the
    row-per-warp kernels and agree with the plain versions (int8, bf16):
    K1 and K2 at H = 58112 (gate/up's and q/k/v's rows), K3 at NQ = 58112
    (W_o's rows); K3 at H = 58112 still takes the ring."""
    g = torch.Generator(device=dev).manual_seed(300 + B)
    wide_h = decode_layers(L=2, H=58112, NQ=256, NKV=128, I=256, fmt="int8", generator=g,
                           device=dev)
    x = torch.randn((B, 58112), device=dev, generator=g).to(torch.bfloat16)
    attn = torch.randn((B, 256), device=dev, generator=g).to(torch.bfloat16)
    mlp = fused_mlp.fused_mlp_decode.ring_launches
    qkv = fused_qkvo.fused_qkv_decode.ring_launches
    o = fused_qkvo.fused_o_residual.ring_launches
    for a, b in zip(fused_qkvo.fused_qkv_decode(x, wide_h, 1),
                    fused_qkvo.fused_qkv_decode_ref(x, wide_h, 1)):
        _assert_close(a, b, atol=2e-3)
    _assert_close(fused_qkvo.fused_o_residual(attn, x, wide_h, 1),
                  fused_qkvo.fused_o_residual_ref(attn, x, wide_h, 1), atol=2e-3)
    _assert_mlp_close(fused_mlp.fused_mlp_decode(x, wide_h, 1),
                      fused_mlp.fused_mlp_decode_ref(x, wide_h, 1),
                      fused_mlp.intermediate_ulp_bound(x, wide_h, 1))
    assert (fused_mlp.fused_mlp_decode.ring_launches, fused_qkvo.fused_qkv_decode.ring_launches,
            fused_qkvo.fused_o_residual.ring_launches) == (mlp, qkv, o + 1)
    del wide_h
    wide_nq = decode_layers(L=2, H=256, NQ=58112, NKV=128, I=256, fmt="int8", generator=g,
                            device=dev)
    x = torch.randn((B, 256), device=dev, generator=g).to(torch.bfloat16)
    attn = torch.randn((B, 58112), device=dev, generator=g).to(torch.bfloat16)
    _assert_close(fused_qkvo.fused_o_residual(attn, x, wide_nq, 1),
                  fused_qkvo.fused_o_residual_ref(attn, x, wide_nq, 1), atol=2e-3)
    assert fused_qkvo.fused_o_residual.ring_launches == o + 1


def _mlp_layers(H, I, fmt, generator, device):
    """Post-attention norm and MLP weights of a 2-layer stack (decode_layers'
    formats), without the attention projections."""
    full = decode_layers(L=2, H=H, NQ=256, NKV=256, I=I, fmt=fmt, generator=generator,
                         device=device)
    return {n: full[n] for n in ("post_attention_layernorm", "gate_proj", "up_proj",
                                 "down_proj")}


def _check_ring(x, layers, fmt):
    """fused_mlp_decode on the weight ring (its counter rises by one) against
    the plain version, held to the one-ulp bound of the bf16 intermediate."""
    ring, q4g = (fused_mlp.fused_mlp_decode.ring_launches,
                 fused_mlp.fused_mlp_decode.q4g_ring_launches)
    got = fused_mlp.fused_mlp_decode(x, layers, 1)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _assert_mlp_close(got, fused_mlp.fused_mlp_decode_ref(x, layers, 1),
                      fused_mlp.intermediate_ulp_bound(x, layers, 1))
    assert fused_mlp.fused_mlp_decode.ring_launches == ring + 1
    assert fused_mlp.fused_mlp_decode.q4g_ring_launches == q4g + (fmt == "q4g")


@pytest.mark.parametrize("fmt", ["int8", "q4g"])
@pytest.mark.parametrize("B", [2, 3, 4, 5, 6, 7])
def test_fused_mlp_ring_batches(dev, fmt, B):
    """K1's weight ring at 8B width (H = 4096, I = 14336) at every B between
    test_fused_decode_kernels' 1 and 8 (its BT = 2, 4, 8 instances with rows
    unused, and down in two launches from B = 5)."""
    g = torch.Generator(device=dev).manual_seed(100 + B)
    layers = _mlp_layers(4096, 14336, fmt, g, dev)
    _check_ring(torch.randn((B, 4096), device=dev, generator=g).to(torch.bfloat16), layers,
                fmt)


@pytest.mark.parametrize("fmt", ["int8", "q4g"])
@pytest.mark.parametrize("width", [(768, 1280), (256, 512), (512, 2816)])
@pytest.mark.parametrize("B", [1, 3, 8])
def test_fused_mlp_ring_ragged(dev, fmt, width, B):
    """Small widths whose row counts are not multiples of the 132 bands nor
    of the stages (q4g at H = 768: 6 scales a row, bands on even rows)."""
    H, I = width
    g = torch.Generator(device=dev).manual_seed(H + B)
    layers = _mlp_layers(H, I, fmt, g, dev)
    _check_ring(torch.randn((B, H), device=dev, generator=g).to(torch.bfloat16), layers, fmt)


def test_fused_decode_q4g_transposed_down_scales(dev):
    """The down projection's q4g scales in prepare_fused_layers' [L, in/128,
    out] layout give the canonical layout's result."""
    g = torch.Generator(device=dev).manual_seed(3)
    layers = decode_layers(L=2, H=512, NQ=512, NKV=256, I=1024, fmt="q4g",
                           generator=g, device=dev)
    x = torch.randn((4, 512), device=dev, generator=g).to(torch.bfloat16)
    want = fused_mlp.fused_mlp_decode(x, layers, 1)
    dw = layers["down_proj"]["weight"]
    layers["down_proj"] = {"weight": {"q4g": dw["q4g"],
                                      "scale": dw["scale"].transpose(1, 2).contiguous()}}
    _assert_close(fused_mlp.fused_mlp_decode(x, layers, 1), want, atol=0)


def test_fused_decode_kernels_reject(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    layers = decode_layers(L=1, H=256, NQ=256, NKV=128, I=512, fmt="int8",
                           generator=g, device=dev)
    with pytest.raises(ValueError):         # no rows
        fused_qkvo.fused_qkv_decode(
            torch.zeros((0, 256), device=dev, dtype=torch.bfloat16), layers, 0)
    with pytest.raises(ValueError):         # fp16 activations
        fused_mlp.fused_mlp_decode(torch.zeros((1, 256), device=dev, dtype=torch.float16),
                                   layers, 0)
    dense = decode_layers(L=1, H=256, NQ=256, NKV=128, I=512, fmt="fp32", generator=g,
                          device=dev)
    with pytest.raises(ValueError):         # fp32 weights with bf16 activations
        fused_mlp.fused_mlp_decode(torch.zeros((1, 256), device=dev, dtype=torch.bfloat16),
                                   dense, 0)
    q4g = {"weight": {"q4g": torch.zeros((1, 256, 192), dtype=torch.int8, device=dev),
                      "scale": torch.ones((1, 256, 3), device=dev)}}
    layers = {"input_layernorm": {"weight": torch.ones((1, 384), device=dev)},
              "q_proj": q4g, "k_proj": q4g, "v_proj": q4g}
    with pytest.raises(ValueError):         # q4g with H = 384, not a multiple of 256
        fused_qkvo.fused_qkv_decode(
            torch.zeros((1, 384), device=dev, dtype=torch.bfloat16), layers, 0)


def _qweight(fmt, N, K, g, dev):
    w = torch.randn((N, K), device=dev, generator=g) * 0.02
    if fmt == "q4g":
        return quant.quantize_weight_q4g(w)
    return quant.quantize_weight(w, 4 if fmt == "q4" else 8)


# (fmt, M, N, K): decode rows (split over K), prefill rows, a ragged M and a
# ragged N (not a multiple of the 64-wide tile)
QMM_CASES = [("q4", 1, 1024, 4096), ("q4", 2048, 4096, 4096), ("q4", 37, 1000, 1024),
             ("int8", 1, 4096, 14336), ("int8", 130, 1000, 512),
             ("q4g", 1, 1024, 4096), ("q4g", 2048, 14336, 4096), ("q4g", 2048, 4096, 14336),
             ("q4g", 70, 1000, 768)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", QMM_CASES)
def test_quant_matmul_kernels(dev, case, dtype):
    """K6 (q4, int8) and K7 (q4g) against their plain versions: exact
    products, fp32 sums in another order, out in x's dtype (bf16: the
    instance the routing names, for K6 the weight ring at one row, wgmma at
    2048 and 130, mma.sync at 37; fp32: the FFMA kernel)."""
    fmt, M, N, K = case
    g = torch.Generator(device=dev).manual_seed(M + N)
    qw = _qweight(fmt, N, K, g, dev)
    x = torch.randn((M, K), device=dev, generator=g).to(dtype)
    f32 = dtype == torch.float32
    if fmt == "q4g":
        before = (qm.quant_matmul_q4g.launches, qm.quant_matmul_q4g.f32_launches)
        got, want = qm.quant_matmul_q4g(x, qw), qm.quant_matmul_q4g_ref(x, qw)
        assert (qm.quant_matmul_q4g.launches, qm.quant_matmul_q4g.f32_launches) == (
            before[0] + 1, before[1] + f32)
    else:
        names = (f"{fmt}_launches", f"{fmt}_f32_launches")
        before = [getattr(qm.quant_matmul, n) for n in names]
        got, want = qm.quant_matmul(x, qw), qm.quant_matmul_ref(x, qw)
        assert [getattr(qm.quant_matmul, n) for n in names] == [before[0] + 1, before[1] + f32]
    assert got.dtype == dtype
    _assert_close(got, want, **(dict(atol=ATOL_F32, rtol=RTOL_F32) if f32 else dict(atol=2e-3)))


@pytest.mark.parametrize("N", [1024, 4096, 14336])
@pytest.mark.parametrize("M", [64, 100, 2048])
def test_quant_matmul_q4g_wgmma(dev, M, N):
    """K7's wgmma instance (bf16 x, M >= 64: weights dequantized in
    registers, group scales on fp32 partial sums) against
    quant_matmul_q4g_ref, at the prefill's rows, a ragged M and the decode
    limit, and the k/v, q/o and MLP widths; a split over K where the tiles
    leave SMs idle (M = 64, 100)."""
    g = torch.Generator(device=dev).manual_seed(M + N)
    qw = _qweight("q4g", N, 4096, g, dev)
    x = torch.randn((M, 4096), device=dev, generator=g).to(torch.bfloat16)
    assert qm.q4g_route(M, x.dtype) == "wgmma"
    before = (qm.quant_matmul_q4g.launches, qm.quant_matmul_q4g.wgmma_launches)
    got = qm.quant_matmul_q4g(x, qw)
    assert (qm.quant_matmul_q4g.launches, qm.quant_matmul_q4g.wgmma_launches) == (
        before[0] + 1, before[1] + 1)
    _assert_close(got, qm.quant_matmul_q4g_ref(x, qw), atol=2e-3)


def test_quant_matmul_q4g_route(dev):
    """The route on the card is q4g_route's: bf16 below 64 rows and fp32 x
    do not launch the wgmma instance."""
    g = torch.Generator(device=dev).manual_seed(3)
    qw = _qweight("q4g", 512, 1024, g, dev)
    for M, dtype, wgmma in ((63, torch.bfloat16, 0), (64, torch.bfloat16, 1),
                            (64, torch.float32, 0), (300, torch.float32, 0)):
        x = torch.randn((M, 1024), device=dev, generator=g).to(dtype)
        before = qm.quant_matmul_q4g.wgmma_launches
        got = qm.quant_matmul_q4g(x, qw)
        assert qm.quant_matmul_q4g.wgmma_launches == before + wgmma
        tol = dict(atol=ATOL_F32, rtol=RTOL_F32) if dtype == torch.float32 else dict(atol=2e-3)
        _assert_close(got, qm.quant_matmul_q4g_ref(x, qw), **tol)


@pytest.mark.parametrize("rows", [16, 64, 256])
@pytest.mark.parametrize("variant", ["i32", "magic", "twodot"])
def test_p1_variants(dev, variant, rows):
    """Each P1 variant against its plain version (K6's) at the probe's shape."""
    from slime_tpu_torch.probes import quant_matmul as p1
    x, qw = p1.make_inputs(dev, seed=rows)
    _assert_close(p1.matvec(x, qw, variant, rows), p1.plain(x, qw), atol=2e-3)


@pytest.mark.parametrize("mode", ["dma", "unpack", "unpack_dot"])
def test_p4_modes(dev, mode):
    """Each P4 mode against its plain version on two layers of the stacked
    gate_proj: the totals exactly, the dots at fp32 tolerance, and the TPU
    kernel's checksum formed from either."""
    from slime_tpu_torch.probes import q4g_unpack as p4
    packed, h = p4.make_inputs(dev, seed=1, shape=(2, 14336, 4096))
    got, want = p4.stream(mode, packed, h), p4.plain(mode, packed, h)
    if mode == "unpack_dot":
        _assert_close(got, want, atol=1e-4, rtol=1e-5)
        got, want = got.cpu(), want.cpu()
    else:
        got = int(got)
        assert got == want
    torch.testing.assert_close(p4.checksum(mode, got), p4.checksum(mode, want), rtol=1e-5,
                               atol=1e-2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [("int8", 37, 1000, 200), ("int8", 1, 4096, 1000),
                                  ("int8", 2048, 4096, 1000), ("int8", 5, 64, 37),
                                  ("q4", 37, 320, 200), ("q4", 1, 4096, 1000),
                                  ("q4", 130, 1000, 1002)])
def test_quant_matmul_kernels_any_k(dev, case, dtype):
    """K6 at a K that is not a multiple of 128 (int8 any K, q4 any even K,
    as JAX's kernel takes the whole row): the masked last k-tile against
    the plain version, with the split over K at one row."""
    fmt, M, N, K = case
    g = torch.Generator(device=dev).manual_seed(M + N + K)
    qw = _qweight(fmt, N, K, g, dev)
    x = torch.randn((M, K), device=dev, generator=g).to(dtype)
    got, want = qm.quant_matmul(x, qw), qm.quant_matmul_ref(x, qw)
    f32 = dtype == torch.float32
    _assert_close(got, want, **(dict(atol=ATOL_F32, rtol=RTOL_F32) if f32 else dict(atol=2e-3)))


def test_quant_matmul_kernels_reject(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.zeros((4, 201), device=dev, dtype=torch.bfloat16)
    w = torch.randn((64, 201), device=dev, generator=g)
    with pytest.raises(ValueError):         # q4 at an odd K: the packing needs pairs
        qm.quant_matmul(x, {"q4": quant.quantize_weight(w[:, :200], 4)["q4"],
                            "scale": torch.ones((64, 1), device=dev)})
    x = torch.zeros((4, 384), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):         # q4g K not a multiple of 256
        qm.quant_matmul_q4g(x, quant.quantize_weight_q4g(
            torch.zeros((64, 384), device=dev), group=64))
    with pytest.raises(ValueError):         # fp16 activations
        qm.quant_matmul(x.half(), _qweight("q4", 64, 384, g, dev))
    with pytest.raises(ValueError):         # grouped q4 has no K6 kernel
        qm.quant_matmul(x, quant.quantize_weight(torch.zeros((64, 384), device=dev),
                                                 4, group=128))


def test_linear_routes_q4g_to_k7_and_q4_to_k6(dev):
    """layers.linear on a CUDA tensor: q4g launches K7, per-row q4 K6 (6
    rows on its weight ring, 80 rows on its wgmma instance), and NF4 / int8
    take the dequantize path (no launch)."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, 3, 512), device=dev, generator=g).to(torch.bfloat16)
    w = torch.randn((256, 512), device=dev, generator=g) * 0.02
    counts = lambda: (qm.quant_matmul_q4g.launches, qm.quant_matmul.q4_launches,  # noqa: E731
                      qm.quant_matmul.int8_launches, qm.quant_matmul.q4_ring_launches,
                      qm.quant_matmul.q4_wgmma_launches, qm.quant_matmul.int8_ring_launches,
                      qm.quant_matmul.int8_wgmma_launches)
    c0 = counts()
    y = L.linear({"weight": quant.quantize_weight_q4g(w)}, x)
    assert y.shape == (2, 3, 256) and counts() == (c0[0] + 1,) + c0[1:]
    q4 = quant.quantize_weight(w, 4)
    y = L.linear({"weight": q4}, x)
    assert counts() == (c0[0] + 1, c0[1] + 1, c0[2], c0[3] + 1) + c0[4:]
    _assert_close(y, qm.quant_matmul_ref(x.reshape(6, 512), q4).reshape(2, 3, 256), atol=2e-3)
    x80 = torch.randn((2, 40, 512), device=dev, generator=g).to(torch.bfloat16)
    y = L.linear({"weight": q4}, x80)
    assert counts() == (c0[0] + 1, c0[1] + 2, c0[2], c0[3] + 1, c0[4] + 1) + c0[5:]
    _assert_close(y, qm.quant_matmul_ref(x80.reshape(80, 512), q4).reshape(2, 40, 256),
                  atol=2e-3)
    L.linear({"weight": quant.quantize_weight_nf4(w)}, x)
    L.linear({"weight": quant.quantize_weight(w, 8)}, x)
    assert counts() == (c0[0] + 1, c0[1] + 2, c0[2], c0[3] + 1, c0[4] + 1) + c0[5:]


def _k6_launches(fmt, route):
    return getattr(qm.quant_matmul, f"{fmt}_{route}_launches")


# K6's weight ring: Llama-3-8B's q/o, k/v and down projections, ragged N and K
K6_RING_WIDTHS = [(4096, 4096), (1024, 4096), (4096, 14336), (1000, 512), (136, 1056)]


@pytest.mark.parametrize("width", K6_RING_WIDTHS, ids=lambda w: f"N{w[0]}-K{w[1]}")
@pytest.mark.parametrize("B", range(1, 9))
@pytest.mark.parametrize("fmt", ["q4", "int8"])
def test_quant_matmul_ring(dev, fmt, B, width):
    """K6 on the weight ring (bf16 x, 1-8 rows) against quant_matmul_ref at
    2e-3 and 2^-7 relative (exact products, fp32 sums in another order, one
    bf16 rounding): exactly one ring launch a call (the down projection at
    B > 4 stages its rows in two groups, two launches of the kernel)."""
    N, K = width
    g = torch.Generator(device=dev).manual_seed(B * N + K)
    qw = _qweight(fmt, N, K, g, dev)
    x = torch.randn((B, K), device=dev, generator=g).to(torch.bfloat16)
    code = qm._Q4 if fmt == "q4" else qm._INT8
    assert qm.k6_route(B, K, x.dtype, code, N, wr.sm_count(x.device)) == "ring"
    before = _k6_launches(fmt, "ring")
    got = qm.quant_matmul(x, qw)
    assert _k6_launches(fmt, "ring") == before + 1
    _assert_close(got, qm.quant_matmul_ref(x, qw), atol=2e-3)


K6_WGMMA_WIDTHS = [(4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336), (1000, 1056),
                   (136, 4128)]


@pytest.mark.parametrize("width", K6_WGMMA_WIDTHS, ids=lambda w: f"N{w[0]}-K{w[1]}")
@pytest.mark.parametrize("M", [64, 100, 2048])
@pytest.mark.parametrize("fmt", ["q4", "int8"])
def test_quant_matmul_wgmma(dev, fmt, M, width):
    """K6's wgmma instance (bf16 x, M >= 64: the integer weights dequantized
    in registers, the per-row scale on the fp32 accumulator) against
    quant_matmul_ref at 2e-3 and 2^-7 relative: the prefill's rows, a ragged
    M and the limit, Llama-3-8B's widths (256-row blocks, 128 for k/v, a
    split over K where the tiles leave SMs idle), a ragged N and a K past
    the last whole stage (TMA's zero fill)."""
    N, K = width
    g = torch.Generator(device=dev).manual_seed(M + N + K)
    qw = _qweight(fmt, N, K, g, dev)
    x = torch.randn((M, K), device=dev, generator=g).to(torch.bfloat16)
    assert qm.k6_route(M, K, x.dtype, qm._Q4 if fmt == "q4" else qm._INT8, N,
                       wr.sm_count(x.device)) == "wgmma"
    before = _k6_launches(fmt, "wgmma")
    got = qm.quant_matmul(x, qw)
    assert _k6_launches(fmt, "wgmma") == before + 1
    _assert_close(got, qm.quant_matmul_ref(x, qw), atol=2e-3)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", [(4616, 3072, 1024, True), (4616, 1024, 1024, True),
                                  (4616, 4096, 1024, True), (4616, 1024, 4096, True),
                                  (100, 1000, 256, False), (4616, 3072, 1000, True),
                                  (77, 1001, 200, True), (130, 96, 37, False),
                                  (65, 33, 1003, True)])
def test_w8a8_kernel(dev, case, dtype):
    """K8 against w8a8_matmul_ref, bf16 and fp32 x, at the CLIP-L tower's
    four linears and at ragged M, N and K (K not a multiple of 16: the row
    pass's element loads and the padded weight copy): the integer dot is
    exact and the epilogue rounds at the same points, so they agree bit for
    bit."""
    M, N, K, with_bias = case
    g = torch.Generator(device=dev).manual_seed(M + N)
    x = (torch.randn((M, K), device=dev, generator=g) * 2).to(dtype)
    x[3] = 0                                  # a zero row: scale 1
    qw = quant.quantize_weight(torch.randn((N, K), device=dev, generator=g) * 0.02, 8)
    bias = torch.randn((N,), device=dev, generator=g) if with_bias else None
    before = (w8.w8a8_matmul.launches, w8.w8a8_matmul.f32_launches)
    got = w8.w8a8_matmul(x, qw, bias)
    assert (w8.w8a8_matmul.launches, w8.w8a8_matmul.f32_launches) == (
        before[0] + 1, before[1] + (dtype == torch.float32))
    assert got.dtype == dtype
    want = w8.w8a8_matmul_ref(x, qw, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    got = w8.w8a8_matmul(x[:, :K - 3].contiguous(), {"q": qw["q"][:, :K - 3],   # a view of W
                                                     "scale": qw["scale"]})
    want = w8.w8a8_matmul_ref(x[:, :K - 3], {"q": qw["q"][:, :K - 3], "scale": qw["scale"]})
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("tile_n", [128, 256])
@pytest.mark.parametrize("form", ["nt", "nn", "nn_bf16"])
@pytest.mark.parametrize("shape", [(1000, 1024, 4096), (300, 256, 784), (32768, 1024, 4096)])
def test_p3_forms(dev, shape, form, tile_n):
    """P3's kernel in each operand form and tile against the exact product
    (int32, or rounded to bf16): equal, at a ragged M and N and at the
    probe's shape."""
    from slime_tpu_torch.probes import int8_dot as p3
    xq, wq, wt = p3.make_inputs(dev, seed=shape[0], shape=shape)
    w = wq if form == "nt" else wt
    got = p3.dot(form, xq, w, tile_n)
    want = p3.plain(form, xq, w)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _bhsd(B, S, heads, D, g, dev):
    """bf16 [B, heads, S, D] in llama's [B, S, heads, D] storage."""
    return torch.randn((B, S, heads, D), device=dev, generator=g).to(
        torch.bfloat16).transpose(1, 2)


# (B, H, KVH, S, D, causal, segments): the serving and stage-1 training
# shapes, GQA group sizes, ragged S, non-causal, packed segments (the third
# one first in a tile); then D = 256: causal GQA at S = 2048, non-causal,
# ragged S = 2000, segments; then D = 384 and 512 (the FFMA kernels' 128- and
# 256-column chunks): causal GQA, ragged, segments, non-causal
FLASH_CASES = [(1, 32, 8, 2048, 128, True, False), (4, 32, 8, 2048, 128, True, False),
               (2, 4, 2, 200, 128, False, False),
               (1, 4, 1, 2000, 128, True, False), (1, 4, 2, 256, 128, True, True),
               (2, 8, 8, 130, 128, False, True),
               (1, 16, 4, 2048, 256, True, False), (2, 4, 2, 200, 256, False, False),
               (1, 4, 1, 2000, 256, True, False), (1, 4, 2, 256, 256, True, True),
               (2, 8, 8, 130, 256, False, True),
               (1, 8, 2, 1024, 384, True, False), (1, 4, 1, 300, 384, True, True),
               (2, 4, 2, 130, 384, False, False), (1, 4, 2, 512, 512, True, False),
               (1, 4, 2, 200, 512, False, True)]
D256_CASES = FLASH_CASES[6:11]
WIDE_CASES = FLASH_CASES[11:]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels(dev, case):
    """K5, K5b, K5c against flash_fwd_ref / flash_bwd_ref. The kernels keep
    an fp32 online softmax over key tiles and round p and ds to bf16 per
    tile; the plain versions work on whole rows: on an H100 the largest
    floor needed was 3.2e-3."""
    from slime_tpu_torch.ops import flash_attention as fa
    B, H, KVH, S, D, causal, segmented = case
    g = torch.Generator(device=dev).manual_seed(S)
    q, k, v, do = (_bhsd(B, S, n, D, g, dev) for n in (H, KVH, KVH, H))
    seg = None
    if segmented:
        seg = torch.ones((B, S), dtype=torch.int32, device=dev)
        seg[:, S // 3:2 * S // 3], seg[:, 2 * S // 3:] = 2, 3
    kw = dict(causal=causal, segment_ids=seg)
    counts = (fa.flash_attention.fwd_launches, fa.flash_attention.dkdv_launches,
              fa.flash_attention.dq_launches)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    ro, rl = fa.flash_fwd_ref(q, k, v, **kw)
    _assert_close(out, ro, atol=5e-3)
    _assert_close(lse, rl, atol=5e-3)
    delta = (do.float() * ro.float()).sum(-1)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, do, rl, delta, **kw)
    dq = fa.flash_bwd_dq(q, k, v, do, rl, delta, **kw)
    for got, want in zip((dq, dk, dv), fa.flash_bwd_ref(q, k, v, do, rl, delta, **kw)):
        _assert_close(got, want, atol=5e-3)
    assert (fa.flash_attention.fwd_launches, fa.flash_attention.dkdv_launches,
            fa.flash_attention.dq_launches) == tuple(c + 1 for c in counts)


def test_flash_attention_autograd(dev):
    """flash_attention(use_kernel=True) under autograd: the forward kernel,
    then delta, K5b and K5c."""
    from slime_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v, do = (_bhsd(2, 512, n, 128, g, dev) for n in (8, 2, 2, 8))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention(*leaves, use_kernel=True)
    out.backward(do)
    ro, rl = fa.flash_fwd_ref(q, k, v)
    _assert_close(out.detach(), ro, atol=5e-3)
    delta = (do.float() * ro.float()).sum(-1)
    for leaf, want in zip(leaves, fa.flash_bwd_ref(q, k, v, do, rl, delta)):
        _assert_close(leaf.grad, want, atol=5e-3)


def test_flash_attention_autograd_d256(dev):
    """The same at D = 256, bf16 and fp32."""
    from slime_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(9)
    for dtype, atol in ((torch.bfloat16, 5e-3), (torch.float32, 1e-4)):
        q, k, v, do = (_bhsd(1, 384, n, 256, g, dev).to(dtype) for n in (4, 2, 2, 4))
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        before = fa.flash_attention.dq_d256_launches
        out = fa.flash_attention(*leaves, use_kernel=True)
        out.backward(do)
        assert fa.flash_attention.dq_d256_launches == before + 1
        ro, rl = fa.flash_fwd_ref(q, k, v)
        _assert_close(out.detach(), ro, atol=atol)
        delta = (do.float() * ro.float()).sum(-1)
        for leaf, want in zip(leaves, fa.flash_bwd_ref(q, k, v, do, rl, delta)):
            _assert_close(leaf.grad, want, atol=atol)


def test_flash_attention_auto_rule(dev):
    """use_kernel=None takes the kernel for causal attention at S >= 2048 (S,
    D multiples of 128) and the plain path below that, as JAX's rule does:
    bf16 and fp32 alike (fp32 takes the FFMA kernels), D = 128, 256 and 384
    (the FFMA kernels in bf16)."""
    from slime_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(8)
    for dtype in (torch.bfloat16, torch.float32):
        for S, launched in ((2048, 1), (1024, 0)):
            q, k = _bhsd(1, S, 4, 128, g, dev).to(dtype), _bhsd(1, S, 2, 128, g, dev).to(dtype)
            before = (fa.flash_attention.fwd_launches, fa.flash_attention.fwd_f32_launches)
            fa.flash_attention(q, k, k)
            assert (fa.flash_attention.fwd_launches, fa.flash_attention.fwd_f32_launches) == (
                before[0] + launched, before[1] + launched * (dtype == torch.float32))
    q = _bhsd(1, 2048, 2, 256, g, dev)
    before = fa.flash_attention.fwd_d256_launches
    torch.testing.assert_close(fa.flash_attention(q, q, q).float(),
                               fa.reference_attention(q, q, q).float(), rtol=RTOL, atol=5e-3)
    assert fa.flash_attention.fwd_d256_launches == before + 1
    q = _bhsd(1, 2048, 2, 384, g, dev)
    before = fa.flash_attention.fwd_wide_launches
    torch.testing.assert_close(fa.flash_attention(q, q, q).float(),
                               fa.reference_attention(q, q, q).float(), rtol=RTOL, atol=5e-3)
    assert fa.flash_attention.fwd_wide_launches == before + 1


def test_flash_kernels_reject(dev):
    from slime_tpu_torch.ops import flash_attention as fa
    q = torch.zeros((1, 2, 256, 128), device=dev)
    with pytest.raises(ValueError):                  # fp32 q with bf16 k/v
        fa.flash_attention(q, q.bfloat16(), q.bfloat16(), use_kernel=True)
    with pytest.raises(ValueError):                  # fp16
        fa.flash_attention(q.half(), q.half(), q.half(), use_kernel=True)
    q = torch.zeros((1, 2, 256, 96), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                  # D = 96
        fa.flash_attention(q, q, q, use_kernel=True)
    q = torch.zeros((1, 3, 256, 128), device=dev, dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 256, 128), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                  # KVH does not divide H
        fa.flash_attention(q, k, k, use_kernel=True)


@pytest.mark.parametrize("case", [FLASH_CASES[0], FLASH_CASES[2], FLASH_CASES[3],
                                  FLASH_CASES[4], FLASH_CASES[5]] + D256_CASES + WIDE_CASES)
def test_flash_kernels_fp32(dev, case):
    """The fp32 K5, K5b, K5c (FFMA, nothing rounded) against the plain
    versions in fp32: the same arithmetic with sums in another order."""
    from slime_tpu_torch.ops import flash_attention as fa
    B, H, KVH, S, D, causal, segmented = case
    g = torch.Generator(device=dev).manual_seed(S + 1)
    q, k, v, do = (_bhsd(B, S, n, D, g, dev).float() for n in (H, KVH, KVH, H))
    seg = None
    if segmented:
        seg = torch.ones((B, S), dtype=torch.int32, device=dev)
        seg[:, S // 3:2 * S // 3], seg[:, 2 * S // 3:] = 2, 3
    kw = dict(causal=causal, segment_ids=seg)
    counts = (fa.flash_attention.fwd_f32_launches, fa.flash_attention.dkdv_f32_launches,
              fa.flash_attention.dq_f32_launches)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    ro, rl = fa.flash_fwd_ref(q, k, v, **kw)
    assert out.dtype == torch.float32
    _assert_close(out, ro, atol=1e-4)
    _assert_close(lse, rl, atol=1e-4)
    delta = (do * ro).sum(-1)
    dk, dv = fa.flash_bwd_dkdv(q, k, v, do, rl, delta, **kw)
    dq = fa.flash_bwd_dq(q, k, v, do, rl, delta, **kw)
    for got, want in zip((dq, dk, dv), fa.flash_bwd_ref(q, k, v, do, rl, delta, **kw)):
        assert got.dtype == torch.float32
        _assert_close(got, want, atol=1e-4)
    assert (fa.flash_attention.fwd_f32_launches, fa.flash_attention.dkdv_f32_launches,
            fa.flash_attention.dq_f32_launches) == tuple(c + 1 for c in counts)


# (n, H, KVH, S/n, causal): group size 4 (Llama-3-8B's 32/8) and MHA, at the
# kernel's smallest shard and at the context-parallel prefill's S/n = 2048
RING_CASES = [(n, H, KVH, Sn, causal) for n in (2, 4) for H, KVH in ((32, 8), (8, 8))
              for Sn in (64, 2048) for causal in (True, False)]


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_attention_rdma_kernel(dev, case):
    """K9 against its plain version (the TPU kernel's fp32 arithmetic through
    the same protocol) on n virtual ranks: bf16 out, fp32 sums in another
    order, p split into two bf16 halves for P.V."""
    from slime_tpu_torch.ops import ring_attention_rdma as rd
    n, H, KVH, Sn, causal = case
    g = torch.Generator(device=dev).manual_seed(n * Sn + H)
    q, k, v = (_bhsd(1, n * Sn, heads, 128, g, dev) for heads in (H, KVH, KVH))
    before = rd.ring_attention_rdma.launches
    got = rd.ring_attention_rdma(q, k, v, ring=n, causal=causal)
    assert rd.ring_attention_rdma.launches == before + n
    _assert_close(got, rd.ring_attention_rdma_ref(q, k, v, ring=n, causal=causal), atol=2e-3)


def test_ring_attention_rdma_kernel_rejects(dev):
    """Only inputs that do not fit [B, H, S, D] / [B, KVH, S, D] raise."""
    from slime_tpu_torch.ops import ring_attention_rdma as rd
    q = torch.zeros((1, 4, 256, 64), device=dev)
    with pytest.raises(ValueError):                  # k's head dim differs from q's
        rd.ring_attention_rdma(q, q[..., :32], q[..., :32], ring=2)
    with pytest.raises(ValueError):                  # KVH = 3 does not divide H = 4
        rd.ring_attention_rdma(q, q[:, :3], q[:, :3], ring=2)


# (dtype, D, n, S/n, causal): every dtype, D and shard length JAX's kernel
# takes: fp32 at any D (the FFMA kernel), bf16 at D = 128 / 256 (wgmma) and
# at other D (FFMA), shards that are not multiples of the row tiles
ANY_CASES = ([(torch.float32, D, n, 48, c) for D in (8, 16, 64, 80, 256) for n in (2, 4)
              for c in (True, False)]
             + [(torch.bfloat16, D, n, Sn, c) for D, Sn in ((128, 48), (256, 48), (64, 48),
                                                             (12, 40), (80, 100))
                for n in (2, 4) for c in (True, False)]
             + [(torch.float16, 128, 2, 48, True), (torch.bfloat16, 128, 1, 200, True)])


@pytest.mark.parametrize("case", ANY_CASES)
def test_ring_attention_rdma_kernel_any_input(dev, case):
    """K9 against its plain version at the inputs it used to reject: fp32
    (FFMA, the TPU kernel's fp32 arithmetic: sums in another order), bf16 at
    D other than 128 (FFMA, bf16 out) and at S/n = 48, 40 and 100 (a row
    tile stops at its rank's shard). fp16 computes in fp32 and comes back in
    fp16, as JAX's kernel does."""
    from slime_tpu_torch.ops import ring_attention_rdma as rd
    dtype, D, n, Sn, causal = case
    g = torch.Generator(device=dev).manual_seed(n * Sn + D)
    q, k, v = (_bhsd(1, n * Sn, heads, D, g, dev).to(dtype) for heads in (8, 2, 2))
    before = (rd.ring_attention_rdma.launches, rd.ring_attention_rdma.f32_launches)
    got = rd.ring_attention_rdma(q, k, v, ring=n, causal=causal)
    f32 = dtype != torch.bfloat16
    assert (rd.ring_attention_rdma.launches, rd.ring_attention_rdma.f32_launches) == (
        before[0] + n, before[1] + n * f32)
    assert got.dtype == dtype and got.shape == q.shape
    want = rd.ring_attention_rdma_ref(q, k, v, ring=n, causal=causal)
    if dtype == torch.float32:
        _assert_close(got, want, atol=ATOL_F32, rtol=RTOL_F32)
    else:
        _assert_close(got, want, atol=2e-3)


def test_ring_attention_rdma_kernel_wide_grid(dev):
    """B * KVH past 65535 (folded into the grid's first dimension)."""
    from slime_tpu_torch.ops import ring_attention_rdma as rd
    g = torch.Generator(device=dev).manual_seed(5)
    B, KVH, S, D = 8200, 8, 16, 8
    q, k, v = (torch.randn((B, KVH, S, D), device=dev, generator=g) for _ in range(3))
    got = rd.ring_attention_rdma(q, k, v, ring=2)
    _assert_close(got, rd.ring_attention_rdma_ref(q, k, v, ring=2), atol=ATOL_F32,
                  rtol=RTOL_F32)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_attention_rdma_process_group(dev, world, tmp_path):
    """K9 and the collective ring over an NCCL group of ``world`` cards (one
    process each) against the same functions on ``world`` virtual ranks on
    one card: K9 makes the same launches on the same shards, the collective
    ring the same torch operations."""
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} CUDA devices for an NCCL ring")
    from slime_tpu_torch.ops import ring_attention as ra
    from slime_tpu_torch.ops import ring_attention_rdma as rd
    from tests.test_torch_ring_attention import _run_ranks
    g = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (_bhsd(1, 512 * world, heads, 128, g, dev).contiguous() for heads in (8, 2, 2))
    want = {}                 # first, so the ranks find the kernels built
    for causal in (True, False):
        want[f"rdma_{causal}"] = rd.ring_attention_rdma(q, k, v, ring=world, causal=causal)
        want[f"ring_{causal}"] = ra.ring_attention(q, k, v, ring=world, causal=causal)
    torch.cuda.synchronize()
    outs = _run_ranks("attention", world, {"qkv": tuple(t.cpu() for t in (q, k, v))},
                      tmp_path, backend="nccl")
    for name, w in want.items():
        got = torch.cat([o[name] for o in outs], dim=2).to(dev)
        _assert_close(got, w, atol=0 if name.startswith("rdma") else 2e-3)


# ---------------------------------------------------------------------------
# the entry points at their default compute dtype (fp32), kernels vs plain
# ---------------------------------------------------------------------------

def _small_slime_cfg():
    """A small SliME whose paths reach every kernel: head_dim 128 (K5 in the
    2048-position prefill), 336-px crops with 4 ViT heads of 64 (K4), an MLP
    width the fused decode's auto rule takes, in-dims multiples of 256 (q4g)."""
    from slime_tpu_torch.config import LLMConfig, SliMEConfig, VisionConfig
    return SliMEConfig(
        llm=LLMConfig(vocab_size=256, hidden_size=256, intermediate_size=1024,
                      num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
                      max_position_embeddings=4096),
        vision=VisionConfig(image_size=336, patch_size=14, hidden_size=256,
                            intermediate_size=512, num_layers=3, num_heads=4),
        mm_resampler_dim=4, seperator=7, tokenizer_model_max_length=2048,
        bos_token_id=1, eos_token_id=-1)


def _small_slime(cfg, dev, llm_format):
    """fp32 params from seed 0, the LLM layers int8 ("int8") or q4g with the
    W8A8 tower ("q4g"), stacked; int8 lm_head."""
    from slime_tpu_torch.checkpoint import quantize_loaded
    from slime_tpu_torch.models import llama, slime
    params = slime.init(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    params = quantize_loaded(params, cfg, load_bits=8 if llm_format == "int8" else 4,
                             int4_scheme="group", quantize_lm_head=True,
                             quantize_vision=llm_format == "q4g")
    params["llm"]["layers"] = llama.stack_layers(params["llm"]["layers"])
    return params


def _counts():
    return {"k1_f32": fused_mlp.fused_mlp_decode.f32_launches,
            "k2_f32": fused_qkvo.fused_qkv_decode.f32_launches,
            "k3_f32": fused_qkvo.fused_o_residual.f32_launches,
            "k4_f32": ea.encoder_attention.f32_launches,
            "k5_f32": fa.flash_attention.fwd_f32_launches,
            "k7_f32": qm.quant_matmul_q4g.f32_launches,
            "k8_f32": w8.w8a8_matmul.f32_launches}


@pytest.mark.parametrize("llm_format", ["int8", "q4g"])
@pytest.mark.parametrize("B", [1, 65, 128])
def test_decode_step_default_dtype(dev, monkeypatch, llm_format, B):
    """llama.decode_step on stacked int8 / q4g layers at its default fp32
    compute dtype and fused=None (JAX's automatic choice) launches the fp32
    K1-K3 in every layer, at B beyond the former 64-row limit too, and
    agrees with the same step through the plain versions."""
    from slime_tpu_torch.models import llama
    cfg = _small_slime_cfg()
    llm = _small_slime(cfg, dev, llm_format)["llm"]
    g = torch.Generator(device=dev).manual_seed(B)
    tok = torch.randint(0, cfg.llm.vocab_size, (B,), device=dev, generator=g)

    def two_steps():
        cache = llama.init_kv_cache(cfg.llm, B, 8, device=dev)
        logits, cache = llama.decode_step(llm, cache, tok, cfg.llm)
        return llama.decode_step(llm, cache, logits.argmax(-1), cfg.llm)[0]

    before = _counts()
    got = two_steps()
    after = _counts()
    for k in ("k1_f32", "k2_f32", "k3_f32"):
        assert after[k] - before[k] == 2 * cfg.llm.num_layers, (k, before, after)
    plain_kernels(monkeypatch)
    want = two_steps()
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    _assert_close(got, want, atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("llm_format", ["int8", "q4g"])
def test_generate_default_dtype(dev, monkeypatch, llm_format):
    """generate with an image at its default fp32 compute dtype: the fp32
    K4 in the tower (and K8 in the W8A8 one), K5 in the 2048-position
    prefill, K7 on q4g layers, K1-K3 in decode; the first-step logits agree
    with the same prefill through the plain versions, and the greedy tokens
    are the same."""
    import numpy as np

    from slime_tpu_torch import generate as gen
    from slime_tpu_torch.config import IMAGE_TOKEN_INDEX
    from slime_tpu_torch.data.image_ops import make_device_anyres_fn
    cfg = _small_slime_cfg()
    params = _small_slime(cfg, dev, llm_format)
    r = np.random.default_rng(0)
    ids = r.integers(5, cfg.llm.vocab_size, (1, 64))
    ids[:, 2] = IMAGE_TOKEN_INDEX
    ids = torch.from_numpy(ids).to(dev)
    attn = torch.ones((1, 64), dtype=torch.bool, device=dev)
    img = torch.from_numpy(r.integers(0, 255, (672, 672, 3), dtype=np.uint8)).to(dev)
    crops, mask = make_device_anyres_fn((672, 672), device=dev)(img)

    def run():
        toks = gen.generate(params, cfg, ids, attn, crops[None], mask[None], max_new_tokens=4)
        last = gen.prefill(params, cfg, ids, attn, crops[None], mask[None], torch.float32)[0]
        return toks, last

    before = _counts()
    toks, last = run()
    after = _counts()
    moved = {k for k in after if after[k] > before[k]}
    want_moved = {"k1_f32", "k2_f32", "k3_f32", "k4_f32", "k5_f32"} | (
        {"k7_f32", "k8_f32"} if llm_format == "q4g" else set())
    assert moved == want_moved, (before, after)
    plain_kernels(monkeypatch)
    toks_p, last_p = run()
    assert bool(torch.isfinite(last).all())
    _assert_close(last, last_p, atol=1e-3, rtol=1e-4)
    assert torch.equal(toks, toks_p)


@pytest.mark.parametrize("scheme,fmt", [("absmax", "q4"), ("group", "q4g")])
def test_forward_quantized_default_dtype(dev, monkeypatch, scheme, fmt):
    """llama.forward on per-row q4 / q4g layers at its default fp32 compute
    dtype: K6's or K7's fp32 instance in each of a layer's 7 linears and the
    fp32 K5 at S = 2048; the logits agree with the same forward through the
    plain versions."""
    from slime_tpu_torch.checkpoint import quantize_loaded
    from slime_tpu_torch.models import llama, slime
    cfg = _small_slime_cfg()
    params = slime.init(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    llm = quantize_loaded(params, cfg, load_bits=4, int4_scheme=scheme)["llm"]
    assert fmt in llm["layers"][0]["q_proj"]["weight"]
    ids = torch.randint(5, cfg.llm.vocab_size, (1, 2048), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))

    def run():
        return llama.forward(llm, llama.embed(llm, ids).to(torch.float32), cfg.llm)[0]

    def counts():
        k = qm.quant_matmul.q4_f32_launches if fmt == "q4" else qm.quant_matmul_q4g.f32_launches
        return k, fa.flash_attention.fwd_f32_launches

    before = counts()
    got = run()
    after = counts()
    L = cfg.llm.num_layers
    assert (after[0] - before[0], after[1] - before[1]) == (7 * L, L), (before, after)
    plain_kernels(monkeypatch)
    want = run()
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    _assert_close(got, want, atol=1e-3, rtol=1e-4)


def test_vit_remat_default_dtype(dev):
    """vit.apply(remat=True) under autograd on the card: the same features
    and gradients as without remat (only memory changes), through the fp32
    K4 (whose backward recomputes stable_attention)."""
    from slime_tpu_torch.models import vit
    cfg = _small_slime_cfg().vision
    params = vit.init(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    px = torch.randn((2, 3, 336, 336), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))
    outs = []
    for remat in (False, True):
        leaf = params["layers"][0]["fc1"]["weight"].detach().requires_grad_()
        p = dict(params, layers=[dict(params["layers"][0], fc1=dict(
            params["layers"][0]["fc1"], weight=leaf))] + params["layers"][1:])
        before = ea.encoder_attention.f32_launches
        y = vit.apply(p, px, cfg, remat=remat)
        y.square().mean().backward()
        assert ea.encoder_attention.f32_launches > before
        outs.append((y.detach(), leaf.grad))
    _assert_close(outs[1][0], outs[0][0], atol=0, rtol=0)
    _assert_close(outs[1][1], outs[0][1], atol=0, rtol=0)
