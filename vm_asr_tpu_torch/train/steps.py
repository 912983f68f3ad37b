"""Train, eval and inference steps, and segment bucketing (port of
vm_asr_tpu/train/steps.py; reference trainer/trainer.py:98-438).

One train step: one generator forward in training mode; the generator loss
(L1 / L2 / multi-resolution STFT, plus, with GAN training, the adversarial
and feature-matching terms from each discriminator run on real and fake as
one batch with its spectral-norm statistics frozen); the generator's
gradient, taken over its own parameters only, and its update; then each
discriminator's loss on real and on the detached fake from before the
generator's update (two calls, each advancing the power iteration), with
GAN_LOSS_TYPE wgan-gp plus the gradient penalty, its gradient and update;
then the metrics. The metric names are the JAX package's. Under a profiler
the step records its phases as spans (``core.profiling.span``): step >
generator, gen_loss, gen_backward, gen_update, then disc_loss,
disc_backward, disc_update for each discriminator, then metrics; and each
bucket forward of ``bucketed_forward`` a ``generator`` span with its bucket
size and real segments, and on the card whether its forward was a CUDA
graph's replay (``graph_replays``, ``make_forward_fn``).

Under data parallelism (``mesh`` with dp > 1) each rank runs the step on its
rows of the global batch (``batch["rows"]``, from ``parallel.shard_batch``):
the random draws are the global batch's, cut to the rank's rows; the
spectral-convergence term sums its norms over dp; the gradients are averaged
over dp (one ``all_reduce`` of a flat buffer per model; with an ``mp``
axis, over every rank) before the optimizer; and the metrics are averaged over dp, ``disc_gap/<name>_max``
taken from the averaged gaps. Every rank so takes the step that one process
takes on the whole batch. No module is wrapped in DistributedDataParallel:
the penalty's double backward needs none of its hooks, and the checkpoints
keep the modules' own parameter names.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from .. import losses as L
from ..core.profiling import add_counts, span
from ..metrics import get_metrics
from ..parallel import global_rows, mean_, rand_rows


def _dp(mesh) -> bool:
    """Whether the step reduces over a dp group (make_mesh gives one where
    dp > 1; a caller may give one of a single rank, to drive the
    collectives at world size 1)."""
    return mesh is not None and mesh.dp_group is not None


def build_gen_loss_terms(config, mesh=None):
    """(generator loss names, keyword arguments of the STFT loss; with a dp
    mesh, its group, over which the spectral convergence sums)."""
    adv = config.TRAIN.ADVERSARIAL
    stft_kwargs = dict(
        factor_sc=adv.STFT_LOSS.SC_FACTOR,
        factor_mag=adv.STFT_LOSS.MAG_FACTOR,
        emphasize_high_freq=adv.STFT_LOSS.EMPHASIZE_HIGH_FREQ,
        group=mesh.dp_group if _dp(mesh) else None,
    )
    return tuple(config.TRAIN.LOSSES.GEN), stft_kwargs


def _grad_group(mesh):
    """(group, size) the gradients are averaged over: the dp group; with an
    ``mp`` axis, every rank (the default group). An mp group's ranks hold the
    same gradients up to the card's reductions in no fixed order (atomics in
    convolution and GEMM backward kernels), so averaging over them too keeps
    its replicas' weights bitwise alike, step after step. None: nothing to
    average over."""
    if mesh is not None and mesh.mp > 1:
        return None, mesh.dp * mesh.mp
    if _dp(mesh):
        return mesh.dp_group, mesh.dp
    return None


def _rows_of(batch):
    """The draws' global rows for ``batch``: its ``"rows"`` (start, total)
    when it is one rank's share, else the batch itself."""
    rows = batch.get("rows")
    return global_rows(*rows) if rows is not None else contextlib.nullcontext()


def _mean_metrics(metrics: Dict[str, Any], mesh, device) -> Dict[str, Any]:
    """Each metric (a scalar, or a vector of gaps) averaged over dp in one
    ``all_reduce``; as they are, without a dp mesh."""
    if not _dp(mesh):
        return metrics
    vals = [torch.as_tensor(v, dtype=torch.float32, device=device) for v in metrics.values()]
    flat = torch.cat([v.reshape(-1) for v in vals])
    mean_([flat], mesh.dp_group, mesh.dp)
    pieces = flat.split([v.numel() for v in vals])
    return {k: p.view_as(v) for k, p, v in zip(metrics, pieces, vals)}


def _waveform_terms(gen_losses, stft_kwargs, wave_out, y) -> Dict[str, torch.Tensor]:
    terms = {}
    if "l1" in gen_losses:
        terms["l1"] = L.mae_loss(wave_out, y)
    if "l2" in gen_losses:
        terms["l2"] = L.mse_loss(wave_out, y)
    if "multi_resolution_stft" in gen_losses:
        sc, mag = L.multi_resolution_stft_loss(wave_out[:, 0, :], y[:, 0, :], **stft_kwargs)
        terms["multi_resolution_stft"] = sc + mag
    return terms


def gp_alphas(rng: torch.Generator, batch: int, count: int):
    """The wgan-gp interpolation weights of one step: for the discriminator
    of index ``di`` in sorted name order, (``batch``, 1, 1) uniform draws
    from a generator seeded from one draw of the step's ``rng`` and ``di``,
    the counterpart of the JAX step's ``fold_in(rng, di)`` (a stable index,
    never ``hash(name)``). Under data parallelism, this rank's rows of the
    global batch's draws (``parallel.rand_rows``)."""
    base = int(torch.randint(2**62, (1,), generator=rng, device=rng.device).item())
    out = []
    for di in range(count):
        g = torch.Generator(device=rng.device).manual_seed((base + di * 0x9E3779B97F4A7C15) % 2**63)
        out.append(rand_rows((batch, 1, 1), g, rng.device))
    return out


def make_train_step(config, generator: torch.nn.Module,
                    discriminators: Dict[str, torch.nn.Module],
                    gp_alpha: Optional[Callable] = None, mesh=None) -> Callable:
    """Returns train_step(gen_state, disc_states, batch, rng) → (gen_state,
    disc_states, metrics), updating the states in place.

    ``batch``: {"wave_input", "wave_target": (B, 1, T), "highcut": (B,)} on
    the models' device; ``rng``: a ``torch.Generator`` on that device, which
    feeds the generator's DropPath masks and, with GAN_LOSS_TYPE wgan-gp, the
    penalty's interpolation weights (``gp_alphas``; ``gp_alpha(rng, batch,
    count)`` takes their place, e.g. to feed a test the same draws as the JAX
    step). ``train_step.gen_loss_fn(x, y, hf, rng)`` → (total, wave_out,
    terms) is the generator's loss, for gradient checks.

    ``mesh``: a ``parallel.Mesh``; with dp > 1 the step is one rank's share
    of a data-parallel step (the module docstring), and ``batch`` may carry
    ``"rows"``."""
    gen_losses, stft_kwargs = build_gen_loss_terms(config, mesh)
    adv = config.TRAIN.ADVERSARIAL
    gan = bool(adv.ENABLE) and len(discriminators) > 0
    gan_type = adv.GAN_LOSS_TYPE
    gp_alpha = gp_alpha or gp_alphas
    metric_fns = get_metrics(config.TRAIN.METRICS)
    disc_names = tuple(sorted(discriminators))
    disc_gain = float(adv.get("DISC_INPUT_GAIN", 1.0))

    def disc_forward(name, real, fake, update_stats):
        if disc_gain != 1.0:
            real = real * disc_gain
            fake = None if fake is None else fake * disc_gain
        return discriminators[name](real, fake, update_stats=update_stats)

    def gen_loss_fn(x, y, hf, rng):
        generator.train()
        with span("generator"):
            wave_out = generator(x, hf, generator=rng)
        with span("gen_loss"):
            terms = _waveform_terms(gen_losses, stft_kwargs, wave_out, y)
            if gan:
                for name in disc_names:
                    _, y_g, f_r, f_g = disc_forward(name, y, wave_out, update_stats=False)
                    if not adv.ONLY_FEATURE_LOSS:
                        terms[f"adversarial_{name}"] = L.generator_adversarial_loss(y_g, gan_type)
                    if not adv.ONLY_ADVERSARIAL_LOSS:
                        terms[f"features_{name}"] = adv.FEATURE_LOSS_LAMBDA * \
                            L.feature_matching_loss(f_r, f_g)
            return sum(terms.values()), wave_out, terms

    def disc_loss(name, y, fake, alpha):
        penalty = 0.0
        if gan_type == "wgan-gp":
            # Gradient penalty on interpolates (reference trainer.py:374-378,
            # loss.py:237-260), in D's own input space: with DISC_INPUT_GAIN
            # the endpoints are scaled, so the unit-norm target constrains D,
            # not D∘gain. It runs first, on the spectral-norm statistics the
            # JAX step differentiates it with (before this step's passes
            # update them); its pass updates none.
            penalty = L.gradient_penalty(
                lambda v: discriminators[name](v, None, update_stats=False)[0],
                y * disc_gain, fake * disc_gain, alpha, gp_weight=adv.GP_LAMBDA)
        y_r, y_g, _, _ = disc_forward(name, y, fake, update_stats=True)
        gaps = torch.stack([dr.float().mean() - dg.float().mean() for dr, dg in zip(y_r, y_g)])
        return L.discriminator_loss(y_r, y_g, gan_type) + penalty, gaps

    reduce_over = _grad_group(mesh)

    def grads_of(loss, params):
        # Over the model's own parameters only: no gradient builds up elsewhere.
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        if reduce_over is not None:
            mean_(grads, *reduce_over)
        return grads

    def train_step(gen_state, disc_states, batch, rng: torch.Generator):
        with span("step"), _rows_of(batch):
            return step(gen_state, disc_states, batch, rng)

    def step(gen_state, disc_states, batch, rng):
        x, y, hf = batch["wave_input"], batch["wave_target"], batch["highcut"]
        g_total, wave_out, g_terms = gen_loss_fn(x, y, hf, rng)
        with span("gen_backward"):
            grads = grads_of(g_total, gen_state.params)
        with span("gen_update"):
            gen_state.apply_gradients(grads)
        del grads

        metrics = {"total_loss": g_total.detach()}
        metrics.update({f"generator/{k}": v.detach() for k, v in g_terms.items()})
        gaps_of = []
        if gan:
            fake = wave_out.detach()
            d_total = 0.0
            alphas = gp_alpha(rng, y.shape[0], len(disc_names)) if gan_type == "wgan-gp" \
                else [None] * len(disc_names)
            for name, alpha in zip(disc_names, alphas):
                ds = disc_states[name]
                with span("disc_loss", disc=name):
                    d_loss, gaps = disc_loss(name, y, fake, alpha)
                with span("disc_backward", disc=name):
                    grads = grads_of(d_loss, ds.params)
                with span("disc_update", disc=name):
                    ds.apply_gradients(grads)
                del grads
                metrics[f"discriminator/{name}"] = d_loss.detach()
                metrics[f"disc_gap/{name}"] = gaps.detach()  # the vector, until reduced
                metrics[f"disc_gap/{name}_max"] = None
                gaps_of.append(name)
                d_total = d_total + d_loss.detach()
            metrics["total_disc_loss"] = d_total
        with span("metrics"):
            with torch.no_grad():
                out_flat, y_flat = wave_out.detach()[:, 0, :], y[:, 0, :]
                for mname, fn in metric_fns.items():
                    metrics[mname] = fn(out_flat, y_flat, hf=hf)
            order = list(metrics)
            metrics = _mean_metrics({k: v for k, v in metrics.items() if v is not None}, mesh,
                                    y.device)
            # The max over the sub-discriminators of the gaps of the global batch.
            for name in gaps_of:
                gaps = metrics[f"disc_gap/{name}"]
                metrics[f"disc_gap/{name}"] = gaps.mean()
                metrics[f"disc_gap/{name}_max"] = gaps.abs().max()
        return gen_state, disc_states, {k: metrics[k] for k in order}

    train_step.gen_loss_fn = gen_loss_fn
    return train_step


def make_eval_step(config, generator: torch.nn.Module, mesh=None) -> Callable:
    """eval_step(batch) → (wave_out, metrics): forward in eval mode, the
    waveform losses and the metrics, no updates (reference
    trainer.py:224-316). With a dp ``mesh``, ``batch`` is this rank's share
    and the metrics are the global batch's (averaged over dp)."""
    gen_losses, stft_kwargs = build_gen_loss_terms(config, mesh)
    metric_fns = get_metrics(config.TRAIN.METRICS)

    def eval_step(batch):
        x, y, hf = batch["wave_input"], batch["wave_target"], batch["highcut"]
        generator.eval()
        with torch.no_grad():
            wave_out = generator(x, hf)
            terms = _waveform_terms(gen_losses, stft_kwargs, wave_out, y)
            metrics: Dict[str, Any] = {f"generator/{k}": v for k, v in terms.items()}
            metrics["total_loss"] = sum(terms.values()) if terms else 0.0
            out_flat, y_flat = wave_out[:, 0, :], y[:, 0, :]
            for mname, fn in metric_fns.items():
                metrics[mname] = fn(out_flat, y_flat, hf=hf)
        return wave_out, _mean_metrics(metrics, mesh, y.device)

    return eval_step


class _Replay:
    """One captured forward: its graph, and its static inputs and output."""

    def __init__(self, graph, inputs, out):
        self.graph, self.inputs, self.out = graph, inputs, out

    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        for static, x in zip(self.inputs, inputs):
            static.copy_(x)
        self.graph.replay()
        return self.out.clone()


def signature(inputs) -> tuple:
    """The key of a forward's graph: the shape, dtype and device of each
    positional input."""
    return tuple((x.shape, x.dtype, x.device) for x in inputs)


class GraphedForward:
    """forward(*inputs) → the module's output in eval and inference mode,
    replayed from one CUDA graph per signature of its positional tensor
    inputs (the shapes, dtypes and devices of each: x and hf for the
    generator, the images for the classifier), which takes the forward's
    kernel launches off the host.

    A signature's first call runs eagerly on the capture stream, which warms
    what a capture needs there (cuFFT plans, cuBLAS workspaces, the scans'
    look-back workspaces, ops/lookback.py); its second call captures the
    forward and replays it; later calls replay. A replay copies the inputs
    into the graph's and returns a copy of its output, which the caller
    owns: the next replay overwrites the graph's. All graphs share one
    memory pool, so that memory stays near the largest forward's: each
    keeps its output, replays run one after another on the caller's stream,
    and each output is copied before any other replay can write where it
    lies. CPU inputs, and calls while a capture is under way on the current
    stream, take the eager forward. Under a profiler a call on the card adds
    ``graph_replays`` (1 for a replay, else 0) to the innermost span open.
    """

    def __init__(self, module: torch.nn.Module):
        self.module = module
        self.seen = set()
        self.graphs: Dict[tuple, Callable] = {}
        self.streams: Dict[torch.device, torch.cuda.Stream] = {}
        self.pool = None

    def __call__(self, *inputs: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if not self.graphable(inputs[0]):
                return self.module(*inputs)
            key = signature(inputs)
            graph = self.graphs.get(key)
            if graph is None:
                if key not in self.seen:
                    self.seen.add(key)
                    add_counts(graph_replays=0)
                    return self.warm(inputs)
                graph = self.graphs[key] = self.capture(inputs)
            add_counts(graph_replays=1)
            return graph(*inputs)

    def graphable(self, x: torch.Tensor) -> bool:
        return x.is_cuda and not torch.cuda.is_current_stream_capturing()

    def warm(self, inputs) -> torch.Tensor:
        """The eager forward on the capture stream."""
        device = inputs[0].device
        if device not in self.streams:
            self.streams[device] = torch.cuda.Stream(device)
        stream = self.streams[device]
        caller = torch.cuda.current_stream(device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            out = self.module(*inputs)
        caller.wait_stream(stream)
        out.record_stream(caller)
        return out

    def capture(self, inputs) -> _Replay:
        """The forward captured on the capture stream, with static copies of
        the inputs as its inputs."""
        static = [x.clone() for x in inputs]
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.streams[inputs[0].device],
                              capture_error_mode="thread_local"):
            out = self.module(*static)
        return _Replay(graph, static, out)


def make_forward_fn(module: torch.nn.Module) -> Callable:
    """forward(*inputs) → the module's output (the generator's from (x, hf),
    the classifier's logits from its images), in eval and inference mode;
    on the card replayed from a CUDA graph per input signature
    (``GraphedForward``)."""
    module.eval()
    return GraphedForward(module)


# Segment-batch sizes for long clips: at most 8 segments per forward, and
# the tail chunk padded up to the next size, as the JAX package does (there
# to bound XLA's compiles; here it bounds the batch shapes a run sees).
SEG_BUCKETS = (1, 2, 4, 8)


def segment_bucket_counts(num_segments: int) -> Dict[int, int]:
    """How many chunks of each bucket size ``bucketed_forward`` runs for a
    ``num_segments``-segment clip."""
    counts, i = {}, 0
    while i < num_segments:
        rem = min(num_segments - i, SEG_BUCKETS[-1])
        b = next(x for x in SEG_BUCKETS if x >= rem)
        counts[b] = counts.get(b, 0) + 1
        i += rem
    return counts


def bucketed_forward(forward: Callable, seg_batch: torch.Tensor,
                     hf_batch: torch.Tensor) -> torch.Tensor:
    """Run S segments in chunks of at most 8, each padded to a bucket size.

    seg_batch: (S, 1, seg_len); hf_batch: (S,). Tail chunks are zero-padded
    (hf edge-padded) and the padded outputs dropped.
    """
    s = seg_batch.shape[0]
    outs = []
    i = 0
    while i < s:
        rem = min(s - i, SEG_BUCKETS[-1])
        b = next(x for x in SEG_BUCKETS if x >= rem)
        chunk = seg_batch[i:i + rem]
        hfc = hf_batch[i:i + rem]
        if rem < b:
            chunk = F.pad(chunk, (0, 0, 0, 0, 0, b - rem))
            hfc = torch.cat([hfc, hfc[-1:].expand(b - rem)])
        with span("generator", bucket=b, segments=rem):
            outs.append(forward(chunk, hfc)[:rem])
        i += rem
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
