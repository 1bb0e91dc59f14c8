"""The denoisers' AdaLN passes, ``ops/ada_norm``: its plain twins on the CPU
(held bit for bit against the models' chain as it stood before the op: the
DiT's through the benchmark's frozen copy, FLUX's written out below), the
dispatch rule, the launch's description of the streams, and the kernel
``csrc/ada_norm.cu`` against the plain twins on the card.

This file imports neither JAX nor the JAX package; its ``cuda``-marked
tests run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_ada_norm.py
"""

import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from portbench.reference.models import dit as frozen_dit
from sigman_release_torch.config import PRESETS
from sigman_release_torch.models import dit, flux
from sigman_release_torch.ops import ada_norm as op

DIT_NORM_EPS, FLUX_NORM_EPS = 1e-5, 1e-6


def draw(shape, seed, dtype=torch.float32, scale=1.0, device="cpu",
         shift=0.0):
    g = torch.Generator().manual_seed(seed)
    return (shift + scale * torch.randn(shape, generator=g)).to(device, dtype)


def seeded(module, seed, dtype):
    """Weights drawn from ``seed`` (norm weights away from 1 and biases away
    from 0, so a dropped one shows), in ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(1.0 + 0.3 * torch.randn(p.shape, generator=g)
                    if p.ndim == 1 else 0.3 * torch.randn(p.shape, generator=g))
    return module.to(dtype)


def mod_rows(batch, dim, k, seed, dtype, device="cpu"):
    """The k chunks [B, 1, D] of a modulation linear's [B, k D] output, as
    the models hand them over (views)."""
    return draw((batch, k * dim), seed, dtype, 0.5, device)[:, None].chunk(
        k, -1)


# ---- the models' chain before the op, for the bit-for-bit tests -----------


def todays_flux_double(block, img, txt, vec, rope):
    img_mod, txt_mod = block.img_mod(vec), block.txt_mod(vec)
    streams, vs = [], []
    for x, mod, attn in ((txt, txt_mod, block.txt_attn),
                         (img, img_mod, block.img_attn)):
        x_mod = flux.modulate(F.layer_norm(x, x.shape[-1:], eps=1e-6),
                              mod[0], mod[1])
        q, k, v = flux.split_heads(attn.qkv(x_mod), block.heads)
        streams.append(attn.norm.stream(q, k))
        vs.append(v)
    q, k = flux.qk_rope(streams, rope)
    out = flux.attention(q, k, torch.cat(vs, dim=1))
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


def todays_flux_single(block, x, vec, rope):
    shift, scale, gate = block.modulation(vec)
    x_mod = flux.modulate(F.layer_norm(x, x.shape[-1:], eps=1e-6), shift,
                          scale)
    qkv, mlp = torch.split(block.linear1(x_mod),
                           [3 * block.dim, flux.MLP_RATIO * block.dim], dim=-1)
    q, k, v = flux.split_heads(qkv, block.heads)
    q, k = flux.qk_rope([block.norm.stream(q, k)], rope)
    attn = flux.attention(q, k, v)
    out = block.linear2(torch.cat(
        [attn, F.gelu(mlp, approximate="tanh")], dim=2))
    return x + gate * out


def flux_tables(s_txt_grid, s_img_grid, axes=(16, 56, 56), device="cpu"):
    ids = torch.cat([flux.rope_ids(1, *s_txt_grid),
                     flux.rope_ids(0, *s_img_grid)])
    return flux.rope_tables(ids.to(device), axes, 1e4)


# ---- CPU ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_twins_are_todays_dit_chain(dtype):
    b, s_cond, s_img, dim = 2, 3, 5, 32
    ada = seeded(frozen_dit.AdaLNZero(dim, dim), 0, dtype)
    temb = draw((b, dim), 1, dtype)
    image, cond = draw((b, s_img, dim), 2, dtype), draw((b, s_cond, dim), 3,
                                                       dtype)
    n_img, n_cond, g_img, g_cond = ada(image, cond, temb)
    sh, sc, gate, esh, esc, egate = ada.linear(F.silu(temb))[:, None].chunk(
        6, -1)
    got = op.norm_modulate_plain([cond, image], [(esh, esc), (sh, sc)],
                                 ada.norm)
    assert got.dtype == dtype
    assert torch.equal(got, torch.cat([n_cond, n_img], dim=1))
    out = draw((b, s_cond + s_img, dim), 4, dtype)
    new = op.gated_residual_plain([cond, image], [egate, gate],
                                  [out[:, :s_cond], out[:, s_cond:]])
    assert torch.equal(new[0], cond + g_cond * out[:, :s_cond])
    assert torch.equal(new[1], image + g_img * out[:, s_cond:])
    again, normed = op.gated_residual_plain(
        [cond, image], [egate, gate], [out[:, :s_cond], out[:, s_cond:]],
        [(esh, esc), (sh, sc)], ada.norm)
    assert all(torch.equal(a, n) for a, n in zip(again, new))
    n_img, n_cond, _, _ = ada(new[1], new[0], temb)
    assert torch.equal(normed, torch.cat([n_cond, n_img], dim=1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_twins_are_todays_flux_chain(dtype):
    b, s_txt, s_img, dim = 2, 3, 5, 32
    txt, img = draw((b, s_txt, dim), 0, dtype), draw((b, s_img, dim), 1,
                                                     dtype)
    txt_mod = mod_rows(b, dim, 6, 2, dtype)
    img_mod = mod_rows(b, dim, 6, 3, dtype)
    norm = op.Norm(None, None, FLUX_NORM_EPS)

    def modulated(x, mod):
        return flux.modulate(F.layer_norm(x, x.shape[-1:], eps=1e-6),
                             mod[0], mod[1])

    got = op.norm_modulate_plain([txt, img], [txt_mod[:2], img_mod[:2]],
                                 norm, join=False)
    assert torch.equal(got[0], modulated(txt, txt_mod))
    assert torch.equal(got[1], modulated(img, img_mod))
    joined = op.norm_modulate_plain([txt, img], [txt_mod[:2], img_mod[:2]],
                                    norm)
    assert torch.equal(joined, torch.cat(got, dim=1))
    ys = [draw((b, s, dim), 4 + s, dtype) for s in (s_img, s_txt)]
    (new_img, new_txt), normed = op.gated_residual_plain(
        [img, txt], [img_mod[2], txt_mod[2]], ys,
        [img_mod[3:5], txt_mod[3:5]], norm, join=False)
    want_img = img + img_mod[2] * ys[0]
    want_txt = txt + txt_mod[2] * ys[1]
    assert torch.equal(new_img, want_img) and torch.equal(new_txt, want_txt)
    assert torch.equal(normed[0], modulated(want_img, img_mod[3:]))
    assert torch.equal(normed[1], modulated(want_txt, txt_mod[3:]))


@pytest.mark.parametrize("block", ["dit", "flux_double", "flux_single"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_blocks_keep_their_outputs(block, dtype):
    before = op.ada_norm.launches
    if block == "dit":
        heads, d, s_cond, grid = 2, 16, 4, 4
        dim = heads * d
        new = seeded(dit.DiTBlock(dim, heads, d, dim), 0, dtype)
        old = frozen_dit.DiTBlock(dim, heads, d, dim).to(dtype)
        old.load_state_dict(new.state_dict())
        image = draw((2, grid * grid, dim), 1, dtype)
        cond = draw((2, s_cond, dim), 2, dtype)
        temb = draw((2, dim), 3, dtype)
        rope = tuple(torch.as_tensor(a) for a in dit.rope_2d(d, grid, grid))
        with torch.no_grad():
            got = new(image, cond, temb, rope)
            want = old(image, cond, temb, rope)
    else:
        heads, d = 2, 32
        dim = heads * d
        img, txt = draw((2, 10, dim), 2, dtype), draw((2, 6, dim), 3, dtype)
        vec = draw((2, dim), 4, dtype)
        rope = flux_tables((2, 3), (2, 5), (8, 12, 12))
        with torch.no_grad():
            if block == "flux_double":
                m = seeded(flux.DoubleStreamBlock(dim, heads), 0, dtype)
                got = m(img, txt, vec, rope)
                want = todays_flux_double(m, img, txt, vec, rope)
            else:
                m = seeded(flux.SingleStreamBlock(dim, heads), 1, dtype)
                x = torch.cat([txt, img], dim=1)
                got = (m(x, vec, rope),)
                want = (todays_flux_single(m, x, vec, rope),)
    assert op.ada_norm.launches == before
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


def test_dit_block_keeps_its_gradients():
    """Under autograd the plain twin runs: the block's gradients are the
    frozen block's."""
    heads, d, dim = 2, 16, 32
    new = seeded(dit.DiTBlock(dim, heads, d, dim), 0, torch.float32)
    old = frozen_dit.DiTBlock(dim, heads, d, dim)
    old.load_state_dict(new.state_dict())
    image, cond = draw((1, 9, dim), 1), draw((1, 2, dim), 2)
    temb = draw((1, dim), 3)
    rope = tuple(torch.as_tensor(a) for a in dit.rope_2d(d, 3, 3))
    for m in (new, old):
        img, cnd = m(image, cond, temb, rope)
        (img.square().sum() + cnd.sum()).backward()
    for (name, p), q in zip(new.named_parameters(), old.parameters()):
        assert torch.equal(p.grad, q.grad), name


def test_patch_embed_hands_the_blocks_contiguous_tokens():
    """The residual stream enters the blocks as contiguous [B, S, D] rows,
    the layout the kernel takes; the tokens themselves are unchanged."""
    cfg = PRESETS["test_tiny"]
    embed = seeded(dit.PatchEmbed(cfg), 0, torch.float32)
    latent = draw((2, cfg.in_channels, cfg.sample_height, cfg.sample_width),
                  1)
    feats = draw((2, cfg.text_embed_dim, 8, 8), 2)
    image, cond = embed(latent, feats)
    assert image.is_contiguous() and cond.is_contiguous()
    assert torch.equal(image, embed.proj(latent).flatten(2).transpose(1, 2)
                       + (0 if not embed.use_sincos else torch.as_tensor(
                           dit.sincos_2d(image.shape[-1], *embed.proj(
                               latent).shape[-2:]))[None]))
    assert torch.equal(cond, embed.cond_proj(feats).flatten(2).transpose(1, 2))


@pytest.mark.parametrize("case", ["cpu_bf16_no_grad", "f32", "autograd",
                                  "other_dim"])
def test_op_takes_the_plain_path_off_the_card(case):
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    dim = 64 if case == "other_dim" else 2048
    x = draw((1, 3, dim), 0, dtype)
    y = draw((1, 3, dim), 1, dtype)
    shift, scale, gate = mod_rows(1, dim, 3, 2, dtype)
    norm = torch.nn.LayerNorm(dim, eps=DIT_NORM_EPS).to(dtype)
    before = op.ada_norm.launches
    with torch.set_grad_enabled(case == "autograd"):
        assert not op.engages([x, y, gate, shift, scale, norm.weight,
                               norm.bias])
        got = op.gated_residual([x], [gate], [y], [(shift, scale)], norm)
        want = op.gated_residual_plain([x], [gate], [y], [(shift, scale)],
                                       norm)
        normed = op.norm_modulate([x], [(shift, scale)], norm)
    assert op.ada_norm.launches == before
    assert torch.equal(got[0][0], want[0][0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(normed, op.norm_modulate_plain([x], [(shift, scale)],
                                                      norm))
    assert got[1].requires_grad == (case == "autograd")


class _Recorder:
    """Stands in for the kernel's library: records each launch's words."""

    def __init__(self):
        self.calls = []

    def ada_norm_launch(self, words, n_streams, batch, dim, gated, norm,
                        weight, bias, eps, stream):
        self.calls.append({"words": list(words), "n": n_streams,
                           "batch": batch, "dim": dim, "gated": gated,
                           "norm": norm, "weight": weight, "bias": bias,
                           "eps": eps})
        return 0


@pytest.mark.parametrize("join", [True, False])
def test_launch_describes_each_stream(monkeypatch, join):
    """The words of one launch: every stream's pointers and strides, y read
    in place from a joined output, the normalised rows at their place in
    the joined buffer (or each in its own), the norm's weights."""
    lib = _Recorder()
    monkeypatch.setattr(op, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 7})())
    b, s_cond, s_img, dim = 2, 3, 5, 2048
    bf = torch.bfloat16
    cond, image = draw((b, s_cond, dim), 0, bf), draw((b, s_img, dim), 1, bf)
    out = draw((b, s_cond + s_img, dim), 2, bf)
    sh, sc, gate, esh, esc, egate = mod_rows(b, dim, 6, 3, bf)
    norm = torch.nn.LayerNorm(dim, eps=DIT_NORM_EPS).to(bf)
    before = op.ada_norm.launches
    new, normed = op.ada_norm([cond, image], [egate, gate],
                              [out[:, :s_cond], out[:, s_cond:]],
                              [(esh, esc), (sh, sc)], norm, join)
    assert op.ada_norm.launches == before + 1
    (call,) = lib.calls
    assert (call["n"], call["batch"], call["dim"], call["gated"],
            call["norm"]) == (2, b, dim, 1, 1)
    assert call["weight"] == norm.weight.data_ptr()
    assert call["bias"] == norm.bias.data_ptr()
    assert call["eps"] == DIT_NORM_EPS
    words = call["words"]
    assert len(words) == 2 * 19
    outs = ([normed[:, :s_cond], normed[:, s_cond:]] if join else normed)
    if join:
        assert normed.shape == (b, s_cond + s_img, dim)
    for i, (x, y, g, (shift, scale)) in enumerate(zip(
            (cond, image), (out[:, :s_cond], out[:, s_cond:]),
            (egate, gate), ((esh, esc), (sh, sc)))):
        w = words[19 * i:19 * (i + 1)]
        assert w == [x.data_ptr(), *x.stride()[:2],
                     y.data_ptr(), *y.stride()[:2],
                     g.data_ptr(), g.stride(0),
                     new[i].data_ptr(), *new[i].stride()[:2],
                     shift.data_ptr(), shift.stride(0),
                     scale.data_ptr(), scale.stride(0),
                     outs[i].data_ptr(), *outs[i].stride()[:2],
                     x.shape[1]]
        assert new[i].shape == x.shape and new[i].is_contiguous()
    if join:
        assert words[19 + 15] == normed.data_ptr() + 2 * s_cond * dim
        assert words[19 + 16] == (s_cond + s_img) * dim
    assert words[3] == out.data_ptr() and words[19 + 3] == (
        out.data_ptr() + 2 * s_cond * dim)


def test_launch_refuses_mismatched_shapes(monkeypatch):
    monkeypatch.setattr(op, "_library", _Recorder)
    x = draw((2, 3, 2048), 0, torch.bfloat16)
    shift, scale = mod_rows(1, 2048, 2, 1, torch.bfloat16)   # batch 1 of 2
    with pytest.raises(ValueError, match="stream 0"):
        op.ada_norm([x], None, None, [(shift, scale)],
                    op.Norm(None, None, 1e-6), True)


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_ada_norm.py)")
    return torch.device("cuda")


def bf16_ulps(a, b):
    """|a - b| in bf16 units in the last place (bit patterns as ordered
    integers)."""
    def ordered(x):
        i = x.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def hold(got, want):
    """The kernel's outputs against the plain twin's: bf16, the same shapes,
    equal bit for bit. Returns the number of elements compared."""
    torch.cuda.synchronize()
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    n = 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.bfloat16
        assert g.is_contiguous()
        diff = bf16_ulps(g, w)
        worst = diff.max().item()
        assert worst == 0, (
            f"up to {worst} ulp apart; {(diff > 0).double().mean().item():.3e}"
            f" of the elements unequal")
        n += g.numel()
    return n


def launched(fn):
    """fn() with exactly one launch of the kernel."""
    before = op.ada_norm.launches
    out = fn()
    assert op.ada_norm.launches == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("batch,s_cond,s_img", [(1, 64, 1024), (3, 7, 25)])
def test_kernel_matches_plain_at_the_dit_geometry(cuda_device, batch, s_cond,
                                                  s_img):
    dim, bf = 2048, torch.bfloat16
    cond = draw((batch, s_cond, dim), 0, bf, 2.0, cuda_device, 0.3)
    image = draw((batch, s_img, dim), 1, bf, 2.0, cuda_device, -0.2)
    out = draw((batch, s_cond + s_img, dim), 2, bf, 1.0, cuda_device)
    sh, sc, gate, esh, esc, egate = mod_rows(batch, dim, 6, 3, bf,
                                             cuda_device)
    norm = seeded(torch.nn.LayerNorm(dim, eps=DIT_NORM_EPS), 4, bf).to(
        cuda_device)
    xs, mods = [cond, image], [(esh, esc), (sh, sc)]
    ys, gates = [out[:, :s_cond], out[:, s_cond:]], [egate, gate]
    with torch.no_grad():
        assert op.engages(op._tensors(xs, gates, ys, mods, norm))
        hold(launched(lambda: op.norm_modulate(xs, mods, norm)),
             op.norm_modulate_plain(xs, mods, norm))
        new, normed = launched(lambda: op.gated_residual(xs, gates, ys, mods,
                                                         norm))
        want_new, want_normed = op.gated_residual_plain(xs, gates, ys, mods,
                                                        norm)
        hold(new, want_new)
        hold(normed, want_normed)
        hold(launched(lambda: op.gated_residual(xs, gates, ys)), want_new)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,s_txt,s_img", [(1, 16, 16), (3, 9, 25)])
def test_kernel_matches_plain_at_the_flux_geometry(cuda_device, batch, s_txt,
                                                   s_img):
    dim, bf = 3072, torch.bfloat16
    norm = flux.NORM
    txt = draw((batch, s_txt, dim), 0, bf, 3.0, cuda_device, 0.5)
    img = draw((batch, s_img, dim), 1, bf, 1.0, cuda_device)
    txt_mod = mod_rows(batch, dim, 6, 2, bf, cuda_device)
    img_mod = mod_rows(batch, dim, 6, 3, bf, cuda_device)
    ys = [draw((batch, s, dim), 4 + s, bf, 1.0, cuda_device)
          for s in (s_img, s_txt)]
    with torch.no_grad():
        # double: both streams, each in its own buffer
        mods = [txt_mod[:2], img_mod[:2]]
        hold(launched(lambda: op.norm_modulate([txt, img], mods, norm,
                                               join=False)),
             op.norm_modulate_plain([txt, img], mods, norm, join=False))
        args = ([img, txt], [img_mod[2], txt_mod[2]], ys,
                [img_mod[3:5], txt_mod[3:5]], norm, False)
        new, normed = launched(lambda: op.gated_residual(*args))
        want_new, want_normed = op.gated_residual_plain(*args)
        hold(new, want_new)
        hold(normed, want_normed)
        # single: the joined sequence, y read from linear2's output
        x = torch.cat([txt, img], dim=1)
        y = draw((batch, s_txt + s_img, dim), 9, bf, 1.0, cuda_device)
        shift, scale, gate = mod_rows(batch, dim, 3, 10, bf, cuda_device)
        hold(launched(lambda: op.norm_modulate([x], [(shift, scale)], norm)),
             op.norm_modulate_plain([x], [(shift, scale)], norm))
        hold(launched(lambda: op.gated_residual([x], [gate], [y])),
             op.gated_residual_plain([x], [gate], [y]))


class _CountCats(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.cats = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.cats += func is torch.ops.aten.cat.default
        return func(*args, **(kwargs or {}))


@pytest.mark.cuda
def test_blocks_launch_three_or_two_times_only_without_grad(cuda_device):
    bf = torch.bfloat16
    heads, d = 32, 64
    dim = heads * d
    block = seeded(dit.DiTBlock(dim, heads, d, 512), 0, bf).to(cuda_device)
    image = draw((2, 16, dim), 1, bf, 1.0, cuda_device)
    cond = draw((2, 4, dim), 2, bf, 1.0, cuda_device)
    temb = draw((2, 512), 3, bf, 1.0, cuda_device)
    rope = tuple(torch.as_tensor(a, device=cuda_device)
                 for a in dit.rope_2d(d, 4, 4))
    before = op.ada_norm.launches
    cats = _CountCats()
    with torch.no_grad(), cats:
        got = block(image, cond, temb, rope)
    assert op.ada_norm.launches == before + 3
    assert cats.cats == 0          # no [cond; image] cat left on the path
    old = frozen_dit.DiTBlock(dim, heads, d, 512).to(bf).to(cuda_device)
    old.load_state_dict(block.state_dict())
    with torch.no_grad():
        want = old(image, cond, temb, rope)
    hold(list(got), list(want))
    block(image, cond, temb, rope)[0].float().sum().backward()
    assert op.ada_norm.launches == before + 3

    heads, dim = 24, 3072
    rope = flux_tables((2, 2), (2, 4), device=cuda_device)
    img = draw((2, 8, dim), 4, bf, 1.0, cuda_device)
    txt = draw((2, 4, dim), 5, bf, 1.0, cuda_device)
    vec = draw((2, dim), 6, bf, 1.0, cuda_device)
    double = seeded(flux.DoubleStreamBlock(dim, heads), 3, bf).to(cuda_device)
    with torch.no_grad():
        got = double(img, txt, vec, rope)
        assert op.ada_norm.launches == before + 6
        hold(list(got), list(todays_flux_double(double, img, txt, vec, rope)))
    del double
    single = seeded(flux.SingleStreamBlock(dim, heads), 4, bf).to(cuda_device)
    x = torch.cat([txt, img], dim=1)
    with torch.no_grad():
        got = single(x, vec, rope)
        assert op.ada_norm.launches == before + 8
        hold(got, todays_flux_single(single, x, vec, rope))


@pytest.mark.cuda
def test_dit_model_launches_three_a_block_from_its_patch_embed(cuda_device):
    """The whole DiT at the served widths: every block's three passes run
    the kernel, the first block's too (the patch embed's tokens arrive in
    the layout the kernel takes)."""
    cfg = PRESETS["dit"].replace(num_layers=2)
    model = seeded(dit.DiTModel(cfg), 0, torch.bfloat16).to(cuda_device)
    latent = draw((2, cfg.in_channels, cfg.sample_height, cfg.sample_width),
                  1, torch.bfloat16, 1.0, cuda_device)
    feats = draw((2, cfg.text_embed_dim, 32, 32), 2, torch.bfloat16, 1.0,
                 cuda_device)
    t = torch.tensor([10, 500], device=cuda_device)
    before = op.ada_norm.launches
    with torch.no_grad():
        out = model(latent, feats, t)
    assert op.ada_norm.launches == before + 3 * cfg.num_layers
    assert torch.isfinite(out).all()


@pytest.mark.cuda
def test_flux_model_launches_three_a_double_and_two_a_single_block(
        cuda_device):
    """The whole FLUX transformer at its served widths: every double
    block's three passes and every single block's two run the kernel (the
    stems and the join before the single blocks hand over the layout the
    kernel takes)."""
    cfg = PRESETS["flux1_dev"].replace(num_layers=2, num_single_layers=2)
    torch.manual_seed(0)
    with torch.device(cuda_device):
        model = flux.FluxModel(cfg).to(torch.bfloat16).eval()
    latent = draw((2, cfg.latent_channels, 16, 16), 1, torch.bfloat16, 1.0,
                  cuda_device)
    feats = draw((2, cfg.text_embed_dim, 8, 8), 2, torch.bfloat16, 1.0,
                 cuda_device)
    t = torch.tensor([0.3, 0.9], device=cuda_device)
    guidance = torch.full((2,), 3.5, device=cuda_device)
    before = op.ada_norm.launches
    with torch.no_grad():
        out = model(latent, feats, t, guidance)
    assert op.ada_norm.launches == (before + 3 * cfg.num_layers
                                    + 2 * cfg.num_single_layers)
    assert out.shape == latent.shape and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["strided_last_dim", "unaligned_rows"])
def test_kernel_refuses_a_layout_it_cannot_read(cuda_device, layout):
    """CUDA bf16 inputs at a served width without grad never turn to the
    plain twin for their layout: the op raises instead."""
    dim, bf = 2048, torch.bfloat16
    if layout == "strided_last_dim":
        x = draw((1, dim, 4), 0, bf, 1.0, cuda_device).transpose(1, 2)
    else:
        x = draw((1, 4 * dim + 1), 0, bf, 1.0, cuda_device)[:, 1:].view(
            1, 4, dim)
    shift, scale = mod_rows(1, dim, 2, 1, bf, cuda_device)
    norm = seeded(torch.nn.LayerNorm(dim, eps=DIT_NORM_EPS), 2, bf).to(
        cuda_device)
    before = op.ada_norm.launches
    with torch.no_grad(), pytest.raises(ValueError, match="16-byte aligned"):
        op.norm_modulate([x], [(shift, scale)], norm)
    assert op.ada_norm.launches == before
