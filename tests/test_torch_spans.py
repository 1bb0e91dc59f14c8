"""The port's one span system, ``utils/timing.StageTimer``, the spans of the
DDIM loop and the DiT block, and the loader's wait in ``fit``.

This file imports neither JAX nor the JAX package; its ``cuda``-marked
test runs on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py

The CPU tests stand in fake CUDA events and a counting
``torch.cuda.synchronize`` where a test needs the CUDA branch.
"""

import time

import pytest
import torch
from torch import nn

from sigman_release_torch.config import PRESETS
from sigman_release_torch.data.dataset import SyntheticAvatarDataset
from sigman_release_torch.diffusion.ddim import DDIMScheduler
from sigman_release_torch.diffusion.pipeline import SamplePipeline
from sigman_release_torch.models.dit import DiTModel
from sigman_release_torch.training.dit_trainer import DiTTrainer
from sigman_release_torch.training.vae_trainer import VAETrainer
from sigman_release_torch.utils.timing import NULL_TIMER, StageTimer

CFG = PRESETS["test_tiny"]
L = CFG.num_layers


class _FakeEvent:
    """A CUDA event on the host clock."""

    def __init__(self, enable_timing=False):
        self.at = None

    def record(self, stream=None):
        self.at = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.at - self.at)


@pytest.fixture
def fake_cuda(monkeypatch):
    """Fake events and a ``torch.cuda.synchronize`` that counts its calls."""
    calls = []
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: calls.append(1))
    return calls


def _dit(seed=0):
    torch.manual_seed(seed)
    return DiTModel(CFG).eval()


def _inputs(b=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    lat = torch.randn((b, CFG.latent_channels, CFG.sample_height,
                       CFG.sample_width), generator=g)
    cond = torch.randn((b, CFG.text_embed_dim, 8, 8), generator=g)
    return lat, cond, torch.tensor([3, 700][:b])


def test_nested_spans_count_and_only_the_outermost_synchronises(fake_cuda):
    timer = StageTimer("cuda")
    with timer("outer"):
        for _ in range(3):
            with timer("inner"):
                with timer("leaf"):
                    pass
    assert timer.counts == {"outer": 1, "inner": 3, "leaf": 3}
    assert len(fake_cuda) == 2               # both ends of "outer" alone
    with timer("outer"):
        pass
    assert len(fake_cuda) == 4
    secs = timer.seconds
    assert set(secs) == {"outer", "inner", "leaf"}
    assert secs["outer"] >= secs["inner"] >= 0.0

    dev_timer = StageTimer("cuda", sync=False)
    with dev_timer("outer"):
        with dev_timer("inner"):
            pass
    assert len(fake_cuda) == 4               # the device mode never drains
    assert dev_timer.counts == {"outer": 1, "inner": 1}
    assert set(dev_timer.seconds) == {"outer", "inner"}


def test_events_are_reused_once_resolved(fake_cuda):
    timer = StageTimer("cuda", sync=False)
    for _ in range(2):                       # two units, read after each
        for _ in range(4):
            with timer("a"):
                pass
        timer.seconds
    assert len(timer._pool) == 4
    assert timer.counts["a"] == 8


def test_spans_are_profiler_ranges_and_the_null_timer_opens_none():
    from torch.profiler import ProfilerActivity, profile

    model, (lat, cond, t) = _dit(), _inputs()

    def names(timer):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with torch.no_grad():
                model(lat, cond, t, timer=timer)
        return {e.name for e in prof.events() if e.name.startswith("span:")}

    assert names(StageTimer("cpu")) == {"span:dit_embed", "span:dit_adaln",
                                        "span:dit_attention", "span:dit_ff"}
    assert names(NULL_TIMER) == set()
    assert NULL_TIMER("a") is NULL_TIMER("b")  # one shared context


@pytest.mark.parametrize("sync", [True, False])
def test_outputs_are_bitwise_equal_with_a_timer_and_without(sync):
    model, (lat, cond, t) = _dit(), _inputs()
    with torch.no_grad():
        plain = model(lat, cond, t)
        timed = model(lat, cond, t, timer=StageTimer("cpu", sync=sync))
    assert torch.equal(plain, timed)
    pipe = SamplePipeline(CFG)
    noise = torch.randn((2, CFG.latent_channels, CFG.sample_height,
                         CFG.sample_width), generator=torch.Generator()
                        .manual_seed(5))
    a = pipe.sample_latents(model, cond, noise=noise, num_inference_steps=3)
    b = pipe.sample_latents(model, cond, noise=noise, num_inference_steps=3,
                            timer=StageTimer("cpu", sync=sync))
    assert torch.equal(a, b)


def test_span_counts_of_one_sampling_call():
    model, (_, cond, _) = _dit(), _inputs()
    timer = StageTimer("cpu")
    SamplePipeline(CFG).sample_latents(
        model, cond, generator=torch.Generator().manual_seed(0),
        num_inference_steps=3, timer=timer)
    assert timer.counts == {"ddim_step": 3, "ddim_update": 3,
                            "dit_embed": 3, "dit_attention": 3 * L,
                            "dit_ff": 3 * L, "dit_adaln": 3 * 3 * L}


def test_recomputed_blocks_open_no_block_span():
    """With gradients recorded (``gradient_checkpointing``: the blocks are
    recomputed) only "dit_embed" is opened: the trainer's path."""
    model, (lat, cond, t) = _dit(), _inputs()
    model.train()
    timer = StageTimer("cpu")
    model(lat, cond, t, timer=timer).sum().backward()
    assert timer.counts == {"dit_embed": 1}


class _SlowLoader:
    """``items`` as batches of one, each after a 50 ms sleep."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __iter__(self):
        for item in self.items:
            time.sleep(0.05)
            yield {k: v[None] for k, v in item.items()}


class _Rows:
    def __init__(self):
        self.rows = []

    def log(self, step, values):
        self.rows.append((step, values))


def _dit_fit_setup():
    cfg = CFG.replace(num_layers=1, lr_scheduler="constant")
    g = torch.Generator().manual_seed(0)
    items = [{"latent": torch.randn((cfg.latent_channels, cfg.sample_height,
                                     cfg.sample_width), generator=g),
              "cond": torch.randn((cfg.text_embed_dim, 8, 8), generator=g)}
             for _ in range(3)]
    return DiTTrainer(cfg, nn.Identity(), nn.Identity(), device="cpu"), items


def _vae_fit_setup():
    ds = SyntheticAvatarDataset(CFG, n_items=3, seed=0)
    items = [{k: v for k, v in ds[i].items() if k != "item"}
             for i in range(3)]
    return VAETrainer(CFG, device="cpu"), items


@pytest.mark.parametrize("setup", [_dit_fit_setup, _vae_fit_setup],
                         ids=["dit", "vae"])
def test_fit_logs_the_loaders_wait(setup):
    trainer, items = setup()
    logger = _Rows()
    trainer.fit(_SlowLoader(items), num_steps=3, log_every=1, logger=logger)
    assert [s for s, _ in logger.rows] == [1, 2, 3]
    last = logger.rows[-1][1]
    assert last["data_wait_mean_s"] >= 0.04
    assert 0.0 < last["data_wait_share"] <= 1.0


@pytest.mark.cuda
def test_device_timer_makes_no_synchronise_inside_a_unit(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_spans.py)")
    dev = torch.device("cuda")
    model = _dit().to(dev)
    lat, cond, t = (x.to(dev) for x in _inputs())
    pipe = SamplePipeline(CFG, DDIMScheduler.from_config(CFG, device=dev))
    timer = StageTimer(dev, sync=False)
    pipe.sample_latents(model, cond, noise=lat, num_inference_steps=3,
                        timer=timer)                      # warm-up
    calls = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: (calls.append(1), real(*a, **k)))
    out = pipe.sample_latents(model, cond, noise=lat, num_inference_steps=3,
                              timer=timer)
    monkeypatch.setattr(torch.cuda, "synchronize", real)
    assert calls == []
    secs = timer.seconds
    assert timer.counts["ddim_step"] == 6
    assert all(v > 0.0 for v in secs.values())
    assert secs["ddim_step"] >= secs["ddim_update"]
    assert torch.isfinite(out).all()
