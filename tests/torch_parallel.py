"""Two-rank runs of the port for the tests/test_torch_parallel_*.py files.

``launch(cases, tmp)`` starts one process per rank, each running this file:
the ranks join one gloo process group on the CPU (``tcp://127.0.0.1``), run
the named cases in order and save each case's result to
``tmp/<case>-<rank>.pt``. A test module launches its cases once, in a
module-scoped fixture, so the ranks start and import torch once per module.
A case reads what the test process prepared (initial weights carried over
from the JAX package, batches made from a numpy seed) from
``tmp/<case>-spec.pt``. The ranks import torch and the port only.

The helpers here (configs, batches, the step and the mp model) serve both
the ranks and the test process, which runs the same code in one process as
the reference.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
T = 2016  # 0.126 s at 16 kHz: a 64-frame spectral image at hop 32

GLOBAL_BATCH = 4

# ---------------------------------------------------------------- the step
STEP_CASES = {
    # The spectral-convergence term (multi-resolution STFT) and the MPD;
    # DIMS 16, so the first stage takes the fused scan (K·D 128).
    "mpd": dict(NAME="MambaUNet", DIMS=16, GEN=["multi_resolution_stft"], DISCRIMINATORS=["mpd"],
                GAN_LOSS_TYPE="lsgan"),
    # The MPD beside the MSD under wgan-gp (the penalty's double backward).
    "msd_wgan": dict(NAME="MambaUNet", DIMS=8, GEN=["l1"], DISCRIMINATORS=["mpd", "msd"],
                     GAN_LOSS_TYPE="wgan-gp"),
    # The MPD under wgan-gp, small enough for the JAX step to compile in seconds.
    "mpd_wgan": dict(NAME="MambaUNet", DIMS=8, GEN=["l1"], DISCRIMINATORS=["mpd"],
                     GAN_LOSS_TYPE="wgan-gp"),
    # "mpd" with DropPath on: the masks of the global batch, each rank its rows.
    "mpd_droppath": dict(NAME="MambaUNet", DIMS=16, GEN=["multi_resolution_stft"],
                         DISCRIMINATORS=["mpd"], GAN_LOSS_TYPE="lsgan", DROP_PATH_RATE=0.3),
}
STEPS_PER_EPOCH = 10


def step_config(c, case: str):
    """The tiny GAN config of ``case`` on a port or JAX default config."""
    spec = STEP_CASES[case]
    c.DATA.TARGET_SR = 16000
    c.DATA.SEGMENT = T / 16000
    c.DATA.STFT.N_FFT = 128
    c.DATA.STFT.HOP_LENGTH = 32
    c.DATA.STFT.WIN_LENGTH = 128
    c.MODEL.NAME = spec["NAME"]
    c.MODEL.VSSM.DIMS = spec["DIMS"]
    c.MODEL.VSSM.DEPTHS = [1, 1, 1, 1]
    c.MODEL.VSSM.DROP_PATH_RATE = spec.get("DROP_PATH_RATE", 0.0)
    c.TRAIN.EPOCHS = 1
    c.TRAIN.WARMUP_EPOCHS = 0
    c.TRAIN.LOSSES.GEN = spec["GEN"]
    adv = c.TRAIN.ADVERSARIAL
    adv.ENABLE = True
    adv.DISCRIMINATORS = spec["DISCRIMINATORS"]
    adv.GAN_LOSS_TYPE = spec["GAN_LOSS_TYPE"]
    adv.MPD_HIDDEN = 2
    adv.MPD_PERIODS = [2, 3]
    adv.MSD_HIDDEN = 16  # the smallest width whose grouped convs divide
    adv.DISC_INPUT_GAIN = 2.0 if spec["GAN_LOSS_TYPE"] == "wgan-gp" else 1.0
    c.DTYPE.COMPUTE = "float32"
    c.AMP_ENABLE = False
    return c


def step_batch(seed: int = 0) -> Dict[str, np.ndarray]:
    """A global batch of 4: the Nyquist-offset input of
    tests/test_torch_train_step.py, with its rows at levels a decade apart
    (the two ranks' spectral norms then differ by ~10×), a random target
    and four highcut bins."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((GLOBAL_BATCH, 1, T))
    x = x + (np.abs(x).max() + 1.0) * (-1.0) ** np.arange(T)
    x[..., :128] = 0.0
    x[..., -128:] = 0.0
    level = np.array([0.05, 0.1, 0.5, 1.0])[:, None, None]
    y = 0.3 * rng.standard_normal((GLOBAL_BATCH, 1, T)) * level
    return dict(wave_input=(0.1 * x * level).astype(np.float32), wave_target=y.astype(np.float32),
                highcut=np.array([16, 40, 24, 32], np.int64))


def record_gradients(state, module, into: dict) -> None:
    """Have ``state``'s optimizer copy the gradients it takes into ``into``,
    by parameter name (the step's, averaged over dp)."""
    names = {id(p): k for k, p in module.named_parameters()}
    apply = state.optimizer.apply

    def recording(grads):
        into.update({names[id(p)]: g.detach().clone() for p, g in zip(state.params, grads)})
        return apply(grads)

    state.optimizer.apply = recording


def _alphas_of(spec: dict, mesh):
    """The penalty's interpolation weights given in ``spec["alphas"]`` (one
    (global batch, 1, 1) array per discriminator, the JAX step's draws),
    this rank's rows of them; None (the step's own draws) without."""
    if "alphas" not in spec:
        return None
    from vm_asr_tpu_torch.parallel import shard_batch

    rows = [shard_batch({"a": torch.tensor(a)}, mesh)["a"] for a in spec["alphas"]]
    return lambda rng, batch, count: rows


def run_step(case: str, spec: dict, mesh=None) -> dict:
    """One port train step of ``case`` from ``spec`` (weights, global
    batch, and optionally the penalty's interpolation weights); with a dp
    ``mesh``, this rank's share of it. Returns the
    metrics, each model's gradients by parameter name (as the optimizer
    took them) and the state_dicts after the step. A mesh with an mp axis
    splits every SS2D's directions over it for the step."""
    from vm_asr_tpu_torch.core import default_config
    from vm_asr_tpu_torch.models import get_discriminators, get_generator
    from vm_asr_tpu_torch.parallel import Mesh, set_activation_mesh, shard_batch
    from vm_asr_tpu_torch.train import DiscState, GenState, make_optimizer, make_train_step

    mesh = mesh or Mesh(1, 1)
    cfg = step_config(default_config(), case)
    gen = get_generator(cfg, "cpu")
    gen.load_state_dict(spec["gen"], strict=True)
    discs = get_discriminators(cfg, "cpu")
    for name, d in discs.items():
        d.load_state_dict(spec["discs"][name], strict=True)
    batch = shard_batch({k: torch.from_numpy(v) for k, v in spec["batch"].items()}, mesh)

    models = {"generator": gen, **discs}
    step = make_train_step(cfg, gen, discs, mesh=mesh, gp_alpha=_alphas_of(spec, mesh))
    gen_state = GenState(gen, make_optimizer(cfg, STEPS_PER_EPOCH, gen))
    disc_states = {n: DiscState(d, make_optimizer(cfg, STEPS_PER_EPOCH, d))
                   for n, d in discs.items()}
    grads = {}
    for name, state in (("generator", gen_state), *disc_states.items()):
        record_gradients(state, models[name], grads.setdefault(name, {}))
    set_activation_mesh(mesh if mesh.mp > 1 else None)
    try:
        _, _, metrics = step(gen_state, disc_states, batch, torch.Generator().manual_seed(0))
    finally:
        set_activation_mesh(None)
    return dict(metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
                state={n: m.state_dict() for n, m in models.items()})


# ------------------------------------------------------- the mp split (SS2D)
def mp_model():
    """tests/test_mp.py's tiny model (depths 1-1-1-1, dims 4, n_fft 64),
    as the port builds it, every parameter then moved by N(0, 0.05²): at
    its init the layers the output starts from are zero, and so is almost
    every other gradient."""
    from vm_asr_tpu_torch.models import DualStreamInteractiveMambaUNet, init_parameters

    model = DualStreamInteractiveMambaUNet(depths=(1, 1, 1, 1), dims=4, n_fft=64, hop_length=16,
                                           win_length=64, drop_path_rate=0.0)
    gen = torch.Generator().manual_seed(0)
    init_parameters(model, gen)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def mp_inputs():
    """tests/test_mp.py's gradient case: x, target (4, 1, 1008), hf."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 1, 16 * 63)).astype(np.float32)
    y = rng.standard_normal((4, 1, 16 * 63)).astype(np.float32)
    return x, y, np.array([5, 6, 7, 8], np.int64)


def run_mp(spec: dict, mesh=None) -> dict:
    """The tiny model's forward and the gradients of mean((out − y)²), with
    the K directions split over ``mesh``'s mp axis when it has one."""
    from vm_asr_tpu_torch.parallel import set_activation_mesh

    model = mp_model()
    model.load_state_dict(spec["state"], strict=True)
    x, y, hf = (torch.from_numpy(a) for a in mp_inputs())
    set_activation_mesh(mesh)
    try:
        out = model(x, hf)
        loss = (out - y).square().mean()
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    finally:
        set_activation_mesh(None)
    return dict(out=out.detach(), grads=dict(zip(names, grads)))


# --------------------------------------------------- the sequence-sharded scan
SEQ_CASES = {
    # L long enough that the masked lanes' exponent would overflow exp()
    # (tests/test_seq_scan.py's NaN regression), on the recurrence route.
    "long": dict(b=1, l=2048, k=1, d=4),
    # K·D 128: the fused route on each shard.
    "fused": dict(b=2, l=512, k=4, d=32),
}


def seq_inputs(case: str):
    """tests/test_seq_scan.py's inputs, at the case's shape, and the weights
    of the loss Σ y·w."""
    s = SEQ_CASES[case]
    b, l, k, d = s["b"], s["l"], s["k"], s["d"]
    rng = np.random.default_rng(0)
    f = np.float32
    u = rng.standard_normal((b, l, k, d)).astype(f)
    dts = (rng.standard_normal((b, l, k, d)) * 0.5).astype(f)
    A = -(rng.random((k, d, 1)) * 2).astype(f)
    Bs = rng.standard_normal((b, l, k, 1)).astype(f)
    Cs = rng.standard_normal((b, l, k, 1)).astype(f)
    Dk = rng.standard_normal((k, d)).astype(f)
    bias = (rng.standard_normal((k, d)) * 0.2).astype(f)
    w = rng.standard_normal((b, l, k, d)).astype(f)
    return (u, dts, A, Bs, Cs, Dk, bias), w


SEQ_NAMES = ("u", "dts", "A", "Bs", "Cs", "D", "bias")
SHARDED = ("u", "dts", "Bs", "Cs")  # inputs cut along L


def run_seq(case: str, group) -> dict:
    """This rank's shard of the sequence-sharded scan: y and the gradients
    of Σ y·w over its shard."""
    from vm_asr_tpu_torch.ops import seq_sharded_selective_scan

    args, w = seq_inputs(case)
    rank, n = torch.distributed.get_rank(group), torch.distributed.get_world_size(group)
    ls = args[0].shape[1] // n
    cut = slice(rank * ls, (rank + 1) * ls)
    ts = [torch.from_numpy(a[:, cut] if name in SHARDED else a).requires_grad_(True)
          for name, a in zip(SEQ_NAMES, args)]
    y = seq_sharded_selective_scan(*ts, group=group)
    grads = torch.autograd.grad((y * torch.from_numpy(w[:, cut])).sum(), ts)
    return dict(y=y.detach(), grads=dict(zip(SEQ_NAMES, grads)))


# ------------------------------------------------- spectral convergence
def sc_inputs():
    """x_mag, y_mag (4, 9, 17) with rows 2-3 ten times rows 0-1: the two
    ranks' norms differ by 10×."""
    rng = np.random.default_rng(3)
    y = np.abs(rng.standard_normal((4, 9, 17))) + 0.1
    x = y * (1.0 + 0.3 * rng.standard_normal(y.shape))
    scale = np.array([1.0, 1.0, 10.0, 10.0])[:, None, None]
    return (x * scale).astype(np.float32), (y * scale).astype(np.float32)


def run_sc(mesh) -> dict:
    """Spectral convergence of this rank's rows with the dp group, its
    gradient in x_mag, and the plain per-rank ratio."""
    from vm_asr_tpu_torch.losses import spectral_convergence_loss
    from vm_asr_tpu_torch.parallel import shard_batch

    x, y = sc_inputs()
    rows = shard_batch({"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, mesh)
    xm = rows["x"].clone().requires_grad_(True)
    sc = spectral_convergence_loss(xm, rows["y"], mesh.dp_group)
    (g,) = torch.autograd.grad(sc, xm)
    return dict(sc=sc.detach(), grad=g, local=spectral_convergence_loss(xm, rows["y"]).detach())


# ------------------------------------------------------------------ ranks
def _case(name: str, tmp: Path):
    from vm_asr_tpu_torch.parallel import make_mesh

    spec = torch.load(spec_path(tmp, name), weights_only=False)
    kind, _, case = name.partition(":")
    if kind == "step":
        return run_step(case, spec, make_mesh(dp=WORLD))
    if kind == "step_mp":
        return run_step(case, spec, make_mesh(dp=1, mp=WORLD))
    if kind == "mp":
        return run_mp(spec, make_mesh(dp=1, mp=WORLD))
    if kind == "seq":
        return run_seq(case, make_mesh(dp=1, mp=WORLD).mp_group)
    if kind == "sc":
        return run_sc(make_mesh(dp=WORLD))
    raise ValueError(name)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _file(name: str) -> str:
    return name.replace(":", "_")


def launch(cases: List[str], tmp: Path, timeout: float = 600) -> Dict[str, list]:
    """Run ``cases`` on WORLD ranks; {case: [rank 0's result, rank 1's]}.
    Each case's ``tmp/<case>-spec.pt`` must be written first."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--init", init, "--tmp", str(tmp),
         "--cases", ",".join(cases)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    if any(p.returncode for p in procs):
        raise RuntimeError("\n".join(f"rank {r} (exit {p.returncode}):\n{o}"
                                     for r, (p, o) in enumerate(zip(procs, outs))))
    return {c: [torch.load(tmp / f"{_file(c)}-{r}.pt", weights_only=False)
                for r in range(WORLD)] for c in cases}


def spec_path(tmp: Path, case: str) -> Path:
    """Where the test process puts what ``case`` starts from."""
    return tmp / f"{_file(case)}-spec.pt"


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--init", required=True)
    p.add_argument("--tmp", required=True)
    p.add_argument("--cases", required=True)
    a = p.parse_args()
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=a.init, rank=a.rank,
                                         world_size=WORLD)
    try:
        tmp = Path(a.tmp)
        for name in a.cases.split(","):
            torch.save(_case(name, tmp), tmp / f"{_file(name)}-{a.rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
