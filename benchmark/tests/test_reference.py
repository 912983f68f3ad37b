"""The benchmark's plain reference against the port, at a size a CPU holds,
in float32: the generator (eval and training mode), the MPD, the learning
rate, AdamW, a whole GAN step, and the inference path from a wav file."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from benchmark.reference import serve as ref_serve
from benchmark.reference.generator import Generator
from benchmark.reference.mpd import MPD
from benchmark.reference.precision import Products
from benchmark.reference.train import AdamW, Step, learning_rate
from benchmark.weights import make_state

BENCH = Path(__file__).resolve().parents[1]
T = 63 * 240  # 64 STFT frames at hop 240: a 256 × 64 image at n_fft 512

TINY = {"MODEL": {"VSSM": {"DIMS": 8, "DEPTHS": [1, 1, 1, 1]}},
        "DATA": {"SEGMENT": T / 48000, "STFT": {"N_FFT": 512, "WIN_LENGTH": 512}},
        "TRAIN": {"ADVERSARIAL": {"MPD_HIDDEN": 2, "MPD_PERIODS": [2, 3]}},
        "AMP_ENABLE": False}


def _merge(d, over):
    for k, v in over.items():
        if isinstance(v, dict):
            _merge(d[k], v)
        else:
            d[k] = v
    return d


@pytest.fixture(scope="module")
def cfg():
    from benchmark.harness import program_config

    d = json.loads((BENCH / "configs" / "vmasr48k_d16.json").read_text())["program"]
    d = _merge(d, TINY)
    return d, program_config({"program": d}, "unused")


def _meta(cls, d):
    with torch.device("meta"):
        return cls(d, Products())


def _signal(seed, rows=2):
    g = torch.Generator().manual_seed(seed)
    return 0.1 * torch.randn(rows, 1, T, generator=g)


def test_generator_matches_port(cfg):
    from benchmark.program import generator

    d, c = cfg
    sd = make_state(_meta(Generator, d), 123, "cpu")
    ref = Generator(d, Products())
    ref.load_state_dict(sd)
    prog = generator(c, sd, "cpu")
    x = _signal(0)
    with torch.no_grad():
        want = ref.eval()(x)
        got = prog(x, torch.full((2,), 100))
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))
    # Training mode: the same DropPath masks from generators seeded alike.
    got = prog.train()(x, None, generator=torch.Generator().manual_seed(5))
    want = ref.train()(x, torch.Generator().manual_seed(5)).detach()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


def test_mpd_matches_port(cfg):
    from benchmark.program import discriminators

    d, c = cfg
    sd = make_state(_meta(MPD, d), 7, "cpu")
    ref = MPD(d, Products())
    ref.load_state_dict(sd)
    prog = discriminators(c, {"mpd": sd}, "cpu")["mpd"]
    y, fake = _signal(1), _signal(2)
    for update in (False, True):
        want = ref(y, fake, update_stats=update)
        got = prog(y, fake, update_stats=update)
        for w, g in zip(want[0] + want[1], got[0] + got[1]):
            assert torch.allclose(g, w, rtol=1e-5, atol=1e-6)
    for k, v in ref.state_dict().items():
        assert torch.allclose(prog.state_dict()[k], v, rtol=1e-5, atol=1e-7), k


def test_learning_rate_and_adamw_match_port(cfg):
    from vm_asr_tpu_torch.train import make_optimizer

    d, c = cfg
    module = torch.nn.Linear(3, 4)
    prog = make_optimizer(c, 8, module)
    assert [learning_rate(d, 8, n) for n in range(0, 120, 7)] == \
        pytest.approx([prog.schedule(n) for n in range(0, 120, 7)], rel=1e-12)
    params = {k: p.detach().clone() for k, p in module.named_parameters()}
    ref = AdamW(d, params, 8)
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        grads = {k: torch.randn(p.shape, generator=g) for k, p in params.items()}
        ref.step(grads)
        prog.apply([grads[k] for k, _ in module.named_parameters()])
    for k, p in module.named_parameters():
        assert torch.allclose(p.detach(), params[k], rtol=1e-6, atol=1e-9)


def test_gan_step_matches_port(cfg):
    from benchmark.program import discriminators, generator
    from vm_asr_tpu_torch.train import GenState, DiscState, make_optimizer, make_train_step

    d, c = cfg
    gen_sd = make_state(_meta(Generator, d), 11, "cpu")
    mpd_sd = make_state(_meta(MPD, d), 12, "cpu")
    ref = Step(d, gen_sd, mpd_sd, 8, Products(), "cpu")
    gen = generator(c, gen_sd, "cpu")
    mpd = discriminators(c, {"mpd": mpd_sd}, "cpu")
    gs = GenState(gen, make_optimizer(c, 8, gen))
    ds = {"mpd": DiscState(mpd["mpd"], make_optimizer(c, 8, mpd["mpd"]))}
    step = make_train_step(c, gen, mpd)
    y = _signal(3)
    x = y.clone()
    x[..., 1::2] = 0.0
    batch = {"wave_input": x, "wave_target": y, "highcut": torch.full((2,), 85)}
    _, _, metrics = step(gs, ds, batch, torch.Generator().manual_seed(9))
    losses = ref(x, y, torch.Generator().manual_seed(9))
    assert [float(metrics["total_loss"]), float(metrics["total_disc_loss"])] == \
        pytest.approx(losses, rel=1e-5)
    # The gradients as AdamW got them (its first moments) agree to rounding;
    # the first update is lr · g / (|g| + eps), so where |g| is near eps
    # rounding moves it by up to lr: few elements, and never further.
    lr = learning_rate(d, 8, 0)
    for state, ref_opt, ref_params in ((gs, ref.gen_opt, ref.gen_params),
                                       (ds["mpd"], ref.mpd_opt, ref.mpd_params)):
        tx = state.optimizer.tx
        off, total = 0, 0
        scales = {k: float(m.abs().max()) for k, m in ref_opt.m.items()}
        floor = sorted(scales.values())[len(scales) // 2]
        for k, p in state.module.named_parameters():
            m = tx.state[p]["exp_avg"]
            scale = max(scales[k], floor)  # some leaves' gradients are all but zero
            assert torch.allclose(m, ref_opt.m[k], rtol=0, atol=1e-4 * scale), k
            diff = (p.detach() - ref_params[k].detach()).abs()
            assert float(diff.max()) <= 2.01 * lr, k
            off += int((diff > 1e-3 * lr).sum())
            total += diff.numel()
        assert off <= 0.01 * total


def test_inference_path_matches_port(cfg, tmp_path):
    """A 16 kHz wav of two and a half segments through the port's
    Inferencer and through the reference's read, resampling (scipy against
    the port's C++ resampler, within 1e-5), padding, unfold and fold."""
    from benchmark.program import generator
    from vm_asr_tpu_torch.train import Inferencer

    d, c = cfg
    sd = make_state(_meta(Generator, d), 5, "cpu")
    t = np.arange(int(2.5 * T / 3)) / 16000
    audio = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
    path = tmp_path / "clip.wav"
    wavfile.write(path, 16000, (audio * 32767).astype(np.int16))
    from benchmark.harness import quiet_logger

    inf = Inferencer(c, generator(c, sd, "cpu"), logger=quiet_logger(),
                     output_dir=str(tmp_path), device="cpu")
    got = inf.infer_file(str(path), quiet=True)[0, 0]
    ref = Generator(d, Products())
    ref.load_state_dict(sd)
    want = ref_serve.enhance(ref.eval(), d, str(path), "cpu")
    assert got.shape == want.shape
    assert float((got - want).norm() / want.norm()) < 1e-3
