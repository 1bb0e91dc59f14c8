"""The denoisers' per-head QK RMSNorm and RoPE, ``ops/qk_norm_rope``: its
plain twin on the CPU (held bit for bit against the models' chain as it
stood before the op: the DiT's through the benchmark's frozen copy, FLUX's
written out below), the dispatch rule, and the kernel ``csrc/qk_norm_rope.cu``
against the plain twin on the card.

This file imports neither JAX nor the JAX package; its ``cuda``-marked
tests run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_qk_norm_rope.py
"""

import pytest
import torch
import torch.nn.functional as F

from chip_smoke import bf16_ulps
from portbench.reference.models import dit as frozen_dit
from sigman_release_torch.config import PRESETS
from sigman_release_torch.models import dit, flux
from sigman_release_torch.ops import qk_norm_rope as op

TINY = PRESETS["test_tiny"]
HEADS, HEAD_DIM = TINY.num_attention_heads, TINY.attention_head_dim


def draw(shape, seed, dtype=torch.float32, scale=1.0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(device, dtype)


def seeded(module, seed, dtype):
    """Weights drawn from ``seed`` (norm weights away from 1, so a dropped
    weight shows), in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(1.0 + 0.3 * torch.randn(p.shape, generator=g)
                    if p.ndim == 1 else 0.3 * torch.randn(p.shape, generator=g))
    return module.to(dtype)


def dit_tables(grid, head_dim=HEAD_DIM, device="cpu"):
    return tuple(torch.as_tensor(a, device=device)
                 for a in dit.rope_2d(head_dim, grid, grid))


# ---- the models' chain before the op, for the bit-for-bit tests -----------


def todays_flux_norm(x, scale):
    xf = x.float()
    rrms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
    return (xf * rrms).to(x.dtype) * scale


def todays_flux_rope_attention(q, k, v, rope):
    cos, sin = rope
    q = frozen_dit.apply_rope(q, cos, sin).to(v.dtype)
    k = frozen_dit.apply_rope(k, cos, sin).to(v.dtype)
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    b, _, s, _ = out.shape
    return out.transpose(1, 2).reshape(b, s, -1)


def todays_qk(attn, q, k, v):
    return (todays_flux_norm(q, attn.query_norm.scale).to(v.dtype),
            todays_flux_norm(k, attn.key_norm.scale).to(v.dtype))


def todays_double(block, img, txt, vec, rope):
    img_mod, txt_mod = block.img_mod(vec), block.txt_mod(vec)
    qkv = []
    for x, mod, attn in ((txt, txt_mod, block.txt_attn),
                         (img, img_mod, block.img_attn)):
        x_mod = flux.modulate(F.layer_norm(x, x.shape[-1:], eps=1e-6),
                              mod[0], mod[1])
        q, k, v = flux.split_heads(attn.qkv(x_mod), block.heads)
        q, k = todays_qk(attn.norm, q, k, v)
        qkv.append((q, k, v))
    q, k, v = (torch.cat([t, i], dim=1) for t, i in zip(*qkv))
    out = todays_flux_rope_attention(q, k, v, rope)
    s = txt.shape[1]
    out = {"txt": out[:, :s], "img": out[:, s:]}
    res = []
    for name, x, mod, attn, mlp in (
            ("img", img, img_mod, block.img_attn, block.img_mlp),
            ("txt", txt, txt_mod, block.txt_attn, block.txt_mlp)):
        x = x + mod[2] * attn.proj(out[name])
        x = x + mod[5] * mlp(flux.modulate(
            F.layer_norm(x, x.shape[-1:], eps=1e-6), mod[3], mod[4]))
        res.append(x)
    return res[0], res[1]


def todays_single(block, x, vec, rope):
    shift, scale, gate = block.modulation(vec)
    x_mod = flux.modulate(F.layer_norm(x, x.shape[-1:], eps=1e-6), shift,
                          scale)
    qkv, mlp = torch.split(block.linear1(x_mod),
                           [3 * block.dim, flux.MLP_RATIO * block.dim], dim=-1)
    q, k, v = flux.split_heads(qkv, block.heads)
    q, k = todays_qk(block.norm, q, k, v)
    attn = todays_flux_rope_attention(q, k, v, rope)
    out = block.linear2(torch.cat(
        [attn, F.gelu(mlp, approximate="tanh")], dim=2))
    return x + gate * out


# ---- CPU ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_twin_is_todays_dit_chain(dtype):
    b, s_cond, grid = 2, 4, 4
    s = s_cond + grid * grid
    q = draw((b, s, HEADS, HEAD_DIM), 0, dtype)
    k = draw((b, s, HEADS, HEAD_DIM), 1, dtype)
    wq = draw((HEAD_DIM,), 2, dtype, 0.3) + 1
    wk = draw((HEAD_DIM,), 3, dtype, 0.3) + 1
    rope = dit_tables(grid)
    got = op.qk_norm_rope_plain([(q, k, wq, wk)], rope, s_cond, 1e-6, False)
    norm = frozen_dit.RMSNormPerHead(HEAD_DIM)
    want = []
    for x, w in ((q, wq), (k, wk)):
        x = norm.normalize(x, w)
        want.append(torch.cat([x[:, :s_cond], frozen_dit.apply_rope(
            x[:, s_cond:], *rope).to(x.dtype)], dim=1))
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_twin_is_todays_flux_chain(dtype):
    b, heads, d, s_txt, s_img = 2, 2, 32, 6, 10
    qkv = [draw((b, s, 3 * heads * d), 10 + s, dtype)
           for s in (s_txt, s_img)]
    streams = []
    for i, x in enumerate(qkv):
        q, k, _ = flux.split_heads(x, heads)
        streams.append((q, k, draw((d,), 20 + i, dtype, 0.3) + 1,
                        draw((d,), 30 + i, dtype, 0.3) + 1))
    rope = flux.rope_tables(torch.cat([flux.rope_ids(1, 2, 3),
                                       flux.rope_ids(0, 2, 5)]), (8, 12, 12),
                            1e4)
    got = op.qk_norm_rope_plain(streams, rope, 0, 1e-6, True)
    want = [torch.cat([todays_flux_norm(st[i], st[2 + i]) for st in streams],
                      dim=1) for i in (0, 1)]
    want = [frozen_dit.apply_rope(w, *rope).to(dtype) for w in want]
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("case", ["cpu_bf16_no_grad", "f32", "autograd"])
def test_op_takes_the_plain_path_off_the_card(case):
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    q = draw((1, 5, 2, 64), 0, dtype)
    k = draw((1, 5, 2, 64), 1, dtype)
    w = torch.nn.Parameter(draw((64,), 2, dtype) + 1)
    rope = dit_tables(2, 64)
    streams = [(q, k, w, w)]
    before = op.qk_norm_rope.launches
    with torch.set_grad_enabled(case == "autograd"):
        assert not op.engages(streams, rope)
        got = op.qk_norm_rope(streams, rope, 1, 1e-6, False)
        want = op.qk_norm_rope_plain(streams, rope, 1, 1e-6, False)
    assert op.qk_norm_rope.launches == before
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert got[0].requires_grad == (case == "autograd")


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_joint_attention_keeps_its_output(dtype, rope):
    dim = HEADS * HEAD_DIM
    new = seeded(dit.JointAttention(dim, HEADS, HEAD_DIM), 0, dtype)
    old = frozen_dit.JointAttention(dim, HEADS, HEAD_DIM).to(dtype)
    old.load_state_dict(new.state_dict())
    image, cond = draw((2, 16, dim), 1, dtype), draw((2, 4, dim), 2, dtype)
    tables = dit_tables(4) if rope else None
    before = op.qk_norm_rope.launches
    with torch.no_grad():
        got = new(torch.cat([cond, image], dim=1), 4, tables)
        want = old(image, cond, tables)
    assert op.qk_norm_rope.launches == before
    for g, w in zip((got[:, 4:], got[:, :4]), want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flux_blocks_keep_their_outputs(dtype):
    heads, d = 2, 32
    dim = heads * d
    double = seeded(flux.DoubleStreamBlock(dim, heads), 0, dtype)
    single = seeded(flux.SingleStreamBlock(dim, heads), 1, dtype)
    img, txt = draw((2, 10, dim), 2, dtype), draw((2, 6, dim), 3, dtype)
    vec = draw((2, dim), 4, dtype)
    rope = flux.rope_tables(torch.cat([flux.rope_ids(1, 2, 3),
                                       flux.rope_ids(0, 2, 5)]), (8, 12, 12),
                            1e4)
    before = op.qk_norm_rope.launches
    with torch.no_grad():
        got = double(img, txt, vec, rope)
        want = todays_double(double, img, txt, vec, rope)
        x = torch.cat([txt, img], dim=1)
        got_x, want_x = single(x, vec, rope), todays_single(single, x, vec,
                                                            rope)
    assert op.qk_norm_rope.launches == before
    for g, w in zip((*got, got_x), (*want, want_x)):
        assert torch.equal(g, w)


def test_split_heads_norm_still_sums_the_weight_gradient(monkeypatch):
    """Under autograd the plain twin runs on the weight the norm module
    hands over, so ``SplitHeadsNorm``'s gradient sum stays on the path."""
    from sigman_release_torch.parallel import fsdp

    summed = []
    monkeypatch.setattr(fsdp.dist, "all_reduce",
                        lambda grad, group: summed.append(grad.shape))
    attn = dit.JointAttention(HEADS * HEAD_DIM, HEADS, HEAD_DIM)
    attn.norm_q = fsdp.SplitHeadsNorm(attn.norm_q, group=None)
    attn.norm_k = fsdp.SplitHeadsNorm(attn.norm_k, group=None)
    image = draw((1, 16, HEADS * HEAD_DIM), 0)
    x = torch.cat([draw((1, 4, HEADS * HEAD_DIM), 1), image], dim=1)
    attn(x, 4, dit_tables(4)).sum().backward()
    assert summed == [(HEAD_DIM,), (HEAD_DIM,)]
    assert attn.norm_q.weight.grad is not None


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_qk_norm_rope.py)")
    return torch.device("cuda")


def hold_kernel(streams, rope, rope_from, round_before_scale):
    """The kernel against the plain twin on the card: one launch, the same
    shapes, at most 1 ulp apart everywhere. Returns the share of unequal
    elements."""
    assert op.engages(streams, rope)
    before = op.qk_norm_rope.launches
    got = op.qk_norm_rope(streams, rope, rope_from, 1e-6, round_before_scale)
    assert op.qk_norm_rope.launches == before + 1
    want = op.qk_norm_rope_plain(streams, rope, rope_from, 1e-6,
                                 round_before_scale)
    torch.cuda.synchronize()
    unequal = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.bfloat16
        assert g.is_contiguous()
        diff = bf16_ulps(g, w)
        unequal += (diff > 0).double().mean().item() / 2
        assert diff.max().item() <= 1, (
            f"up to {diff.max().item()} ulp apart; "
            f"{(diff > 0).double().mean().item():.3e} of the elements unequal")
    print(f"unequal share {unequal:.3e}")
    return unequal


@pytest.mark.cuda
@pytest.mark.parametrize("batch,s_cond,grid", [(1, 64, 8), (3, 7, 5)])
@pytest.mark.parametrize("weight_dtype", [torch.bfloat16, torch.float32])
def test_kernel_matches_plain_at_the_dit_geometry(cuda_device, batch, s_cond,
                                                  grid, weight_dtype):
    heads, d = 32, 64
    s = s_cond + grid * grid
    x = draw((batch, s, 2, heads * d), 0, torch.bfloat16, 3.0, cuda_device)
    q, k = (x[:, :, i].reshape(batch, s, heads, d) for i in (0, 1))
    w = [draw((d,), i, weight_dtype, 0.3, cuda_device) + 1 for i in (1, 2)]
    rope = dit_tables(grid, d, cuda_device)
    with torch.no_grad():
        hold_kernel([(q, k, *w)], rope, s_cond, False)
        hold_kernel([(q, k, *w)], None, s_cond, False)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,s_txt,s_img", [(1, 16, 16), (2, 9, 25)])
def test_kernel_matches_plain_at_the_flux_geometry(cuda_device, batch, s_txt,
                                                   s_img):
    heads, d = 24, 128
    streams = []
    for i, s in enumerate((s_txt, s_img)):
        qkv = draw((batch, s, 3 * heads * d), 10 + i, torch.bfloat16, 2.0,
                   cuda_device)
        q, k, _ = flux.split_heads(qkv, heads)
        streams.append((q, k, *(draw((d,), 20 + 2 * i + j, torch.bfloat16,
                                     0.3, cuda_device) + 1 for j in (0, 1))))
    ids = torch.cat([flux.rope_ids(1, 1, s_txt), flux.rope_ids(0, 1, s_img)])
    rope = flux.rope_tables(ids.to(cuda_device), (16, 56, 56), 1e4)
    with torch.no_grad():
        hold_kernel(streams, rope, 0, True)          # double: [txt; img]
        hold_kernel(streams[1:], (rope[0][s_txt:].contiguous(),
                                  rope[1][s_txt:].contiguous()), 0, True)


@pytest.mark.cuda
def test_single_stream_reads_the_packed_linear1_in_place(cuda_device):
    heads, d, b, s = 24, 128, 2, 33
    dim = heads * d
    out = draw((b, s, 3 * dim + 4 * dim), 0, torch.bfloat16, 2.0, cuda_device)
    qkv, _ = torch.split(out, [3 * dim, 4 * dim], dim=-1)
    q, k, _ = flux.split_heads(qkv, heads)
    assert q.stride(1) == 7 * dim
    w = [draw((d,), i, torch.bfloat16, 0.3, cuda_device) + 1 for i in (1, 2)]
    rope = flux.rope_tables(flux.rope_ids(0, 3, 11).to(cuda_device),
                            (16, 56, 56), 1e4)
    with torch.no_grad():
        hold_kernel([(q, k, *w)], rope, 0, True)


@pytest.mark.cuda
def test_models_launch_once_a_block_only_without_grad(cuda_device):
    heads, d = 2, 64
    attn = seeded(dit.JointAttention(heads * d, heads, d), 0,
                  torch.bfloat16).to(cuda_device)
    image = draw((2, 16, heads * d), 1, torch.bfloat16, 1.0, cuda_device)
    cond = draw((2, 4, heads * d), 2, torch.bfloat16, 1.0, cuda_device)
    rope = dit_tables(4, d, cuda_device)
    x = torch.cat([cond, image], dim=1)
    before = op.qk_norm_rope.launches
    with torch.no_grad():
        attn(x, 4, rope)
    assert op.qk_norm_rope.launches == before + 1
    attn(x, 4, rope).float().sum().backward()
    assert op.qk_norm_rope.launches == before + 1
    double = seeded(flux.DoubleStreamBlock(heads * 128, heads), 3,
                    torch.bfloat16).to(cuda_device)
    rope = flux.rope_tables(torch.cat([flux.rope_ids(1, 2, 2),
                                       flux.rope_ids(0, 2, 4)]).to(
                                           cuda_device), (16, 56, 56), 1e4)
    img = draw((2, 8, heads * 128), 4, torch.bfloat16, 1.0, cuda_device)
    txt = draw((2, 4, heads * 128), 5, torch.bfloat16, 1.0, cuda_device)
    vec = draw((2, heads * 128), 6, torch.bfloat16, 1.0, cuda_device)
    with torch.no_grad():
        double(img, txt, vec, rope)
    assert op.qk_norm_rope.launches == before + 2
