"""The controls behind the port's trajectory check (PERF.md §6), on the CPU
where JAX and torch are both installed.

    python scripts/torch_trajectory_controls.py forward   # JAX vs port forward at the init
    python scripts/torch_trajectory_controls.py step      # one AdamW step on each side
    python scripts/torch_trajectory_controls.py defects [--gan] [--device cuda|cpu] [--threads N]
    python scripts/torch_trajectory_controls.py floor [--gan] [--device cuda|cpu]
        [--seeds 0,1,...] [--repeat] [--threads N]

- ``forward``: the JAX generator and the port's, from the recorded init
  (artifacts/trajectory_torch), on training batch 0 of
  ``scripts/trajectory_overlay.py:make_data`` with and without the
  recording's -40 dB input floor: max |port − JAX| / max |JAX| and the mean
  |port − JAX|.
- ``step``: one step of each package's Trainer from the recorded init on
  batch 0 (no-GAN settings): how many weights differ by more than 0.1 of
  the learning rate, and the largest difference in learning rates.
- ``defects`` (no JAX; runs on the card too): the port's 12-epoch
  trajectory with each candidate defect (AdamW β2, weight decay, learning
  rate) against the JAX curve, the worst relative gap per column and the
  columns whose gate (``trajectory.gates``) it breaks; torch on
  ``--threads`` intra-op threads.
- ``floor`` (no JAX; runs on the card too): the port's deterministic run
  against JAX, then the chaos floor from each of ``--seeds``' perturbed
  inits (``trajectory.perturb``) against that run, with the median and the
  largest per column. With ``--repeat`` also: the deterministic run again
  (bitwise equal or not), two runs with torch's default algorithms (their
  gap to each other, to the deterministic run and to JAX) and the defect
  (``trajectory.DEFECT``) against JAX. Last, the warnings torch gave for
  operations without a deterministic version. One JSON line per reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

DEFECTS = [{"TRAIN.OPTIMIZER.BETAS": [0.9, b]} for b in (0.99, 0.98, 0.95, 0.9, 0.8)] + [
    {"TRAIN.WEIGHT_DECAY": 0.1}] + [{"TRAIN.BASE_LR": 1e-3 * f} for f in (0.5, 0.25, 0.1)]


def _jax_generator():
    import jax.numpy as jnp

    import trajectory_overlay as overlay
    from vm_asr_tpu.compat.parity_check import model_kwarg_pair
    from vm_asr_tpu.models.unet import DualStreamInteractiveMambaUNet

    geom = dict(n_fft=overlay.N_FFT, hop_length=overlay.HOP, win_length=overlay.WIN,
                depths=overlay.DEPTHS, dims=overlay.DIMS, samples=overlay.SAMPLES)
    _, kwargs = model_kwarg_pair(geom, 4)
    kwargs.update(dtype=jnp.float32, drop_path_rate=0.0)
    return DualStreamInteractiveMambaUNet(interact="dual", **kwargs)


def _jax_params(init):
    import jax
    import jax.numpy as jnp

    from vm_asr_tpu_torch import trajectory

    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  trajectory._unflatten(init, "gen"))


def _port_generator(init):
    from vm_asr_tpu_torch import trajectory
    from vm_asr_tpu_torch.compat import flax_params_to_state_dict
    from vm_asr_tpu_torch.models import get_generator

    gen = get_generator(trajectory.config(False, tempfile.mkdtemp()), "cpu")
    gen.load_state_dict(flax_params_to_state_dict(trajectory._unflatten(init, "gen")))
    return gen


def forward():
    import jax.numpy as jnp
    import numpy as np
    import torch

    import trajectory_overlay as overlay
    from vm_asr_tpu_torch import trajectory

    batches, _, init, _ = trajectory.load_artifact()
    jm, params, gen = _jax_generator(), _jax_params(init), _port_generator(init)
    floored = batches[0]
    raw = overlay.make_data(len(batches), 4, seed=0)[0]
    for name, (x, _, hc) in (("make_data", raw), ("with the floor", floored)):
        want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                                   jnp.asarray(hc.astype(np.int32)), deterministic=True))
        with torch.no_grad():
            got = gen(torch.from_numpy(x), torch.from_numpy(hc.astype(np.int64))).numpy()
        d = np.abs(got - want)
        print(f"{name}: max|port - JAX| / max|JAX| {d.max() / np.abs(want).max():.4g}, "
              f"mean|port - JAX| {d.mean():.4g}")


def step():
    import jax

    import torch_trajectory_record as record
    import trajectory_overlay as overlay
    from vm_asr_tpu.train.trainer import Trainer as JaxTrainer
    from vm_asr_tpu_torch import trajectory
    from vm_asr_tpu_torch.compat import flax_params_to_state_dict
    from vm_asr_tpu_torch.train import Trainer

    data = trajectory.load_artifact()
    batches, init = data[0][:1], data[2]
    jt = JaxTrainer(record._config(1, False, tempfile.mkdtemp()),
                    {"generator": _jax_generator()}, overlay.JaxReplayLoader(batches), None,
                    mesh=None)
    jt.gen_state = jt.gen_state.replace(params=_jax_params(init))
    jt._train_epoch(1)
    jax_after = flax_params_to_state_dict(jax.device_get(jt.gen_state.params))
    gen = _port_generator(init)
    Trainer(trajectory.config(False, tempfile.mkdtemp()), {"generator": gen},
            trajectory.ReplayLoader(batches), None, logger=trajectory._QUIET).train_epoch(1)
    lr = 1e-3
    far = n = worst = 0
    for k, v in gen.state_dict().items():
        d = (v - jax_after[k]).abs()
        far += int((d > 0.1 * lr).sum())
        n += v.numel()
        worst = max(worst, float(d.max()) / lr)
    print(f"after one step: {far} of {n} weights ({far / n:.3%}) differ by > 0.1 lr; "
          f"the largest difference {worst:.3f} lr")


def defects(gan: bool, device: str, threads: int):
    import torch

    from vm_asr_tpu_torch import trajectory

    torch.set_num_threads(threads)
    data = trajectory.load_artifact()
    arm = "gan" if gan else "nogan"
    ref = data[3][arm]
    for overrides in DEFECTS:
        gap = trajectory.worst_gaps(
            trajectory.run_arm(gan, len(ref), device, data, overrides=overrides), ref)
        print(json.dumps({"arm": arm, "device": device, "defect": overrides, "gap": gap,
                          "breaks": trajectory.broken(gap, trajectory.gates(arm))}), flush=True)


def floor(gan: bool, device: str, seeds, repeat: bool, threads: int):
    import statistics
    import warnings

    import torch

    from vm_asr_tpu_torch import trajectory

    torch.set_num_threads(threads)
    data = trajectory.load_artifact()
    arm = "gan" if gan else "nogan"
    ref = data[3][arm]
    flagged = set()

    def run(**kwargs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rows = trajectory.run_arm(gan, len(ref), device, data, **kwargs)
        flagged.update(str(w.message).splitlines()[0] for w in caught
                       if "deterministic" in str(w.message))
        return rows

    def emit(**reading):
        print(json.dumps({"arm": arm, "device": device, **reading}), flush=True)

    port = run()
    emit(run="port", gap_to_jax=trajectory.worst_gaps(port, ref), final=port[-1])
    if repeat:
        again = run()
        emit(run="port again", bitwise_equal=again == port,
             gap_to_port=trajectory.worst_gaps(again, port))
        loose = [run(deterministic=False) for _ in range(2)]
        emit(run="default algorithms, twice", bitwise_equal=loose[0] == loose[1],
             gap_between=trajectory.worst_gaps(loose[1], loose[0]),
             gap_to_port=[trajectory.worst_gaps(r, port) for r in loose],
             gap_to_jax=[trajectory.worst_gaps(r, ref) for r in loose])
        emit(run="defect", overrides=trajectory.DEFECT,
             gap_to_jax=trajectory.worst_gaps(run(overrides=trajectory.DEFECT), ref))
    floors = []
    for seed in seeds:
        floors.append(trajectory.worst_gaps(run(perturb_seed=seed), port))
        emit(run="floor", seed=seed, gap_to_port=floors[-1])
    if floors:
        emit(run="floor summary", seeds=list(seeds),
             median={k: statistics.median(f[k] for f in floors) for k in floors[0]},
             largest={k: max(f[k] for f in floors) for k in floors[0]})
    emit(run="operations without a deterministic version", warnings=sorted(flagged))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("control", choices=("forward", "step", "defects", "floor"))
    ap.add_argument("--gan", action="store_true")
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--repeat", action="store_true")
    args = ap.parse_args(argv)
    if args.control == "floor":
        floor(args.gan, args.device, [int(s) for s in args.seeds.split(",") if s], args.repeat,
              args.threads)
        return 0
    if args.control == "defects":
        defects(args.gan, args.device, args.threads)
        return 0
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.control == "forward":
        forward()
    else:
        step()
    return 0


if __name__ == "__main__":
    sys.exit(main())
