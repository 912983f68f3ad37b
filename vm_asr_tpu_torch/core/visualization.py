"""TensorBoard writer proxy and audio / waveform / spectrogram artifacts
(port of vm_asr_tpu/core/visualization.py; reference
logger/visualization.py:9-257).

The proxy adds the current step and a `tag/mode` suffix to every call and
logs steps per second. ``torch.utils.tensorboard`` and matplotlib are
imported only when used. Where either is not installed, its part of the
logging is turned off after one warning, as the JAX package does: these are
logging extras, not part of the computation. With TENSORBOARD.ENABLE off
every call does nothing.
"""

from __future__ import annotations

import time

import numpy as np


class TensorboardWriter:
    _SCALAR_FNS = {
        "add_scalar", "add_scalars", "add_audio", "add_image", "add_figure",
        "add_histogram", "add_text",
    }

    def __init__(self, log_dir: str, logger=None, enabled: bool = True):
        self.writer = None
        self.enabled = enabled
        self.logger = logger
        self._plots = True
        if enabled:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                if logger:
                    logger.warning(f"TensorBoard unavailable ({e}); logging to it is off")
                self.enabled = False
            else:
                self.writer = SummaryWriter(log_dir)
        self.step = 0
        self.mode = ""
        self._timer = time.time()

    def set_step(self, step: int, mode: str = "train") -> None:
        self.mode = mode
        self.step = step
        if step == 0:
            self._timer = time.time()
        else:
            dt = time.time() - self._timer
            if self.enabled and dt > 0:
                self.writer.add_scalar(f"{mode}/steps_per_sec", 1.0 / dt, step)
            self._timer = time.time()

    def __getattr__(self, name):
        if name in self._SCALAR_FNS:
            if not self.enabled:
                return lambda *a, **k: None
            fn = getattr(self.writer, name)

            def wrapped(tag, *args, **kwargs):
                kwargs.setdefault("global_step", self.step)
                return fn(f"{tag}/{self.mode}" if self.mode else tag, *args, **kwargs)

            return wrapped
        raise AttributeError(name)

    def flush(self):
        if self.enabled:
            self.writer.flush()

    def close(self):
        if self.enabled:
            self.writer.close()

    def _pyplot(self):
        """matplotlib's pyplot on the Agg backend, or None (with one warning)
        where matplotlib is not installed."""
        if not self._plots:
            return None
        try:
            import matplotlib
        except ImportError:
            if self.logger:
                self.logger.warning("matplotlib is not installed; waveform and "
                                    "spectrogram figures are off")
            self._plots = False
            return None
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt

    # -- artifacts (reference visualization.py:94-257) -------------------------
    def log_audio(self, tag: str, wave: np.ndarray, sample_rate: int) -> None:
        if not self.enabled:
            return
        import torch

        self.add_audio(tag, torch.from_numpy(np.asarray(wave, np.float32).reshape(1, -1)),
                       sample_rate=sample_rate)

    def log_waveform(self, tag: str, wave: np.ndarray) -> None:
        plt = self._pyplot() if self.enabled else None
        if plt is None:
            return
        fig, ax = plt.subplots(figsize=(10, 3))
        ax.plot(np.asarray(wave).reshape(-1))
        ax.set_xlabel("sample")
        ax.set_ylabel("amplitude")
        self.add_figure(tag, fig)
        plt.close(fig)

    def log_outputs(self, wave_in: np.ndarray, wave_out: np.ndarray,
                    wave_target: np.ndarray, config) -> None:
        """Epoch-end Input/Output/Target artifacts, by TENSORBOARD.LOG_ITEMS
        (reference trainer.py:448-457, visualization.py:94-124; the
        'spectogram' spelling kept for config parity)."""
        if not self.enabled:
            return
        items = list(config.TENSORBOARD.LOG_ITEMS)
        names = ["Input", "Output", "Target"]
        waves = [wave_in, wave_out, wave_target]
        if "audio" in items:
            for name, wave in zip(names, waves):
                self.log_audio(name, wave, config.DATA.TARGET_SR)
        if "waveform" in items:
            for name, wave in zip(names, waves):
                self.log_waveform(f"Waveform/{name}", wave)
        if "spectogram" in items or "spectrogram" in items:
            s = config.DATA.STFT
            for name, wave in zip(names, waves):
                self.log_spectrogram(f"Spectrogram/{name}", wave,
                                     s.N_FFT, s.HOP_LENGTH, s.WIN_LENGTH)

    def log_spectrogram(self, tag: str, wave: np.ndarray, n_fft: int,
                        hop_length: int, win_length: int) -> None:
        """Three panels: log2 magnitude, dB and phase
        (reference visualization.py:136-257)."""
        plt = self._pyplot() if self.enabled else None
        if plt is None:
            return
        import torch

        from ..dsp import amplitude_to_db, wav2spectro

        w = torch.from_numpy(np.asarray(wave, np.float32).reshape(1, -1))
        mag, phase = wav2spectro(w, n_fft, hop_length, win_length, "log2")
        db = amplitude_to_db(torch.exp2(mag).square())
        fig, axs = plt.subplots(1, 3, figsize=(16, 4))
        for ax, img, title in zip(axs, [mag[0].numpy(), db[0].numpy(), phase[0].numpy()],
                                  ["log2 magnitude", "dB", "phase"]):
            im = ax.imshow(img, aspect="auto", origin="lower", cmap="viridis")
            ax.set_title(title)
            fig.colorbar(im, ax=ax)
        self.add_figure(tag, fig)
        plt.close(fig)
