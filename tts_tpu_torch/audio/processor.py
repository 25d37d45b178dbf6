"""Host-side audio frontend: the full DSP surface of the reference AudioProcessor.

Capability parity with Mozilla TTS's TTS/utils/audio.py:11-369 (STFT, mel,
spectrogram normalization with range or mean-var stats, Griffin-Lim,
preemphasis, F0, silence trim, mu-law, wav IO) — implemented on numpy for the
data pipeline. A copy of ``tts_tpu.audio.processor``: the port keeps its own
copy so that it imports nothing of the JAX package.

Spectrogram layout is time-major ``(frames, bins)``, as in ``tts_tpu``; the
Mozilla TTS reference uses ``(bins, frames)``.
"""

from __future__ import annotations

import io
import wave
from typing import Optional, Tuple

import numpy as np

from tts_tpu_torch.audio import mel as _mel


class AudioProcessor:
    def __init__(
        self,
        sample_rate: int = 22050,
        num_mels: int = 80,
        fft_size: int = 1024,
        hop_length: int = 256,
        win_length: int = 1024,
        frame_shift_ms: Optional[float] = None,
        frame_length_ms: Optional[float] = None,
        preemphasis: float = 0.0,
        ref_level_db: float = 20.0,
        min_level_db: float = -100.0,
        power: float = 1.5,
        griffin_lim_iters: int = 60,
        signal_norm: bool = True,
        symmetric_norm: bool = True,
        max_norm: float = 4.0,
        clip_norm: bool = True,
        mel_fmin: float = 0.0,
        mel_fmax: Optional[float] = None,
        spec_gain: float = 20.0,
        do_trim_silence: bool = False,
        trim_db: float = 60.0,
        do_sound_norm: bool = False,
        stats_path: Optional[str] = None,
        num_freq: Optional[int] = None,  # accepted for reference-config compat
        **_unused,
    ):
        self.sample_rate = sample_rate
        self.num_mels = num_mels
        if frame_shift_ms is not None:
            hop_length = int(frame_shift_ms / 1000.0 * sample_rate)
        if frame_length_ms is not None:
            win_length = int(frame_length_ms / 1000.0 * sample_rate)
        self.fft_size = fft_size
        self.hop_length = hop_length
        self.win_length = win_length
        self.preemphasis_coef = preemphasis
        self.ref_level_db = ref_level_db
        self.min_level_db = min_level_db
        self.power = power
        self.griffin_lim_iters = griffin_lim_iters
        self.signal_norm = signal_norm
        self.symmetric_norm = symmetric_norm
        self.max_norm = float(max_norm)
        self.clip_norm = clip_norm
        self.mel_fmin = mel_fmin
        self.mel_fmax = mel_fmax
        self.spec_gain = spec_gain
        self.do_trim_silence = do_trim_silence
        self.trim_db = trim_db
        self.do_sound_norm = do_sound_norm
        self.stats_path = stats_path

        self.num_freq = 1 + fft_size // 2
        self.mel_basis = _mel.mel_filterbank(
            sample_rate, fft_size, num_mels, mel_fmin, mel_fmax
        )
        self.inv_mel_basis = np.linalg.pinv(self.mel_basis).astype(np.float32)
        self.window = _mel.pad_center(_mel.hann_window(win_length), fft_size)

        # mean-var normalization stats (≙ setup_scaler, TTS/utils/audio.py:108-133)
        self.mel_scaler: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.linear_scaler: Optional[Tuple[np.ndarray, np.ndarray]] = None
        if stats_path:
            self.setup_scaler(stats_path)

    # -- stats ------------------------------------------------------------

    def setup_scaler(self, stats_path: str) -> None:
        stats = np.load(stats_path, allow_pickle=True).item()
        cfg = stats.get("audio_config", {})
        for key in ("sample_rate", "num_mels", "fft_size", "hop_length", "win_length"):
            if key in cfg:
                assert cfg[key] == getattr(self, key), (
                    f"scale_stats audio config mismatch on '{key}': "
                    f"{cfg[key]} != {getattr(self, key)}"
                )
        self.mel_scaler = (
            np.asarray(stats["mel_mean"], np.float32),
            np.asarray(stats["mel_std"], np.float32),
        )
        self.linear_scaler = (
            np.asarray(stats["linear_mean"], np.float32),
            np.asarray(stats["linear_std"], np.float32),
        )

    # -- stft core --------------------------------------------------------

    def _stft(self, y: np.ndarray) -> np.ndarray:
        """(T,) -> complex (frames, bins); librosa conventions (center/reflect)."""
        pad = self.fft_size // 2
        y = np.pad(y, (pad, pad), mode="reflect")
        n_frames = 1 + (len(y) - self.fft_size) // self.hop_length
        idx = (
            np.arange(n_frames)[:, None] * self.hop_length
            + np.arange(self.fft_size)[None, :]
        )
        frames = y[idx] * self.window
        return np.fft.rfft(frames, n=self.fft_size, axis=-1)

    def _istft(self, spec: np.ndarray, length: Optional[int] = None) -> np.ndarray:
        frames = np.fft.irfft(spec, n=self.fft_size, axis=-1) * self.window
        n_frames = frames.shape[0]
        out_len = self.fft_size + self.hop_length * (n_frames - 1)
        out = np.zeros(out_len, dtype=np.float64)
        wss = np.zeros(out_len, dtype=np.float64)
        w2 = self.window.astype(np.float64) ** 2
        for i in range(n_frames):
            s = i * self.hop_length
            out[s: s + self.fft_size] += frames[i]
            wss[s: s + self.fft_size] += w2
        out /= np.maximum(wss, 1e-10)
        pad = self.fft_size // 2
        out = out[pad: out_len - pad]
        if length is not None:
            out = out[:length]
        return out.astype(np.float32)

    # -- db / normalization ----------------------------------------------

    def _amp_to_db(self, x: np.ndarray) -> np.ndarray:
        return self.spec_gain * np.log10(np.maximum(1e-5, x))

    def _db_to_amp(self, x: np.ndarray) -> np.ndarray:
        return np.power(10.0, x / self.spec_gain)

    def normalize(self, s_db: np.ndarray, is_mel: bool = True) -> np.ndarray:
        """db spectrogram -> normalized (range or mean-var), TTS/utils/audio.py:135-163."""
        if not self.signal_norm:
            return s_db
        scaler = self.mel_scaler if is_mel else self.linear_scaler
        if scaler is not None:
            mean, std = scaler
            return (s_db - mean) / (std + 1e-8)
        s_db = s_db - self.ref_level_db
        s_norm = (s_db - self.min_level_db) / (-self.min_level_db)
        if self.symmetric_norm:
            s_norm = 2.0 * self.max_norm * s_norm - self.max_norm
            if self.clip_norm:
                s_norm = np.clip(s_norm, -self.max_norm, self.max_norm)
        else:
            s_norm = self.max_norm * s_norm
            if self.clip_norm:
                s_norm = np.clip(s_norm, 0.0, self.max_norm)
        return s_norm

    def denormalize(self, s_norm: np.ndarray, is_mel: bool = True) -> np.ndarray:
        if not self.signal_norm:
            return s_norm
        scaler = self.mel_scaler if is_mel else self.linear_scaler
        if scaler is not None:
            mean, std = scaler
            return s_norm * (std + 1e-8) + mean
        s = np.array(s_norm, dtype=np.float32)
        if self.symmetric_norm:
            if self.clip_norm:
                s = np.clip(s, -self.max_norm, self.max_norm)
            s = (s + self.max_norm) * -self.min_level_db / (2 * self.max_norm) + self.min_level_db
        else:
            if self.clip_norm:
                s = np.clip(s, 0.0, self.max_norm)
            s = s * -self.min_level_db / self.max_norm + self.min_level_db
        return s + self.ref_level_db

    # -- public spectrogram API -------------------------------------------

    def apply_preemphasis(self, y: np.ndarray) -> np.ndarray:
        if self.preemphasis_coef == 0.0:
            return y
        return np.concatenate([y[:1], y[1:] - self.preemphasis_coef * y[:-1]])

    def apply_inv_preemphasis(self, y: np.ndarray) -> np.ndarray:
        if self.preemphasis_coef == 0.0:
            return y
        out = np.empty_like(y)
        prev = 0.0
        for i in range(len(y)):
            prev = y[i] + self.preemphasis_coef * prev
            out[i] = prev
        return out

    def spectrogram(self, y: np.ndarray) -> np.ndarray:
        """wav -> normalized linear spectrogram (frames, num_freq)."""
        d = np.abs(self._stft(self.apply_preemphasis(y)))
        return self.normalize(self._amp_to_db(d), is_mel=False).astype(np.float32)

    def melspectrogram(self, y: np.ndarray) -> np.ndarray:
        """wav -> normalized mel spectrogram (frames, num_mels)."""
        d = np.abs(self._stft(self.apply_preemphasis(y)))
        m = d @ self.mel_basis.T
        return self.normalize(self._amp_to_db(m), is_mel=True).astype(np.float32)

    def inv_spectrogram(self, spec: np.ndarray) -> np.ndarray:
        s = self._db_to_amp(self.denormalize(spec, is_mel=False))
        return self.apply_inv_preemphasis(self._griffin_lim(s**self.power))

    def inv_melspectrogram(self, mel: np.ndarray) -> np.ndarray:
        s = self._db_to_amp(self.denormalize(mel, is_mel=True))
        lin = np.maximum(1e-10, s @ self.inv_mel_basis.T)
        return self.apply_inv_preemphasis(self._griffin_lim(lin**self.power))

    def out_linear_to_mel(self, linear: np.ndarray) -> np.ndarray:
        """normalized linear -> normalized mel (TTS/utils/audio.py:246-253)."""
        s = self._db_to_amp(self.denormalize(linear, is_mel=False))
        return self.normalize(self._amp_to_db(s @ self.mel_basis.T), is_mel=True)

    def _griffin_lim(self, mag: np.ndarray) -> np.ndarray:
        rng = np.random.default_rng(0)
        angles = np.exp(2j * np.pi * rng.random(mag.shape))
        cmag = np.abs(mag).astype(np.complex128)
        y = self._istft(cmag * angles)
        for _ in range(self.griffin_lim_iters):
            rebuilt = self._stft(y)
            angles = rebuilt / np.maximum(1e-16, np.abs(rebuilt))
            y = self._istft(cmag * angles)
        return y.astype(np.float32)

    # -- F0 ----------------------------------------------------------------

    def compute_f0(self, y: np.ndarray) -> np.ndarray:
        """Frame-wise F0 via normalized autocorrelation (pyworld-free equivalent
        of TTS/utils/audio.py:291-299)."""
        frame = self.win_length
        hop = self.hop_length
        fmin, fmax = 60.0, 500.0
        lag_min = int(self.sample_rate / fmax)
        lag_max = min(int(self.sample_rate / fmin), frame - 1)
        n_frames = max(0, 1 + (len(y) - frame) // hop)
        f0 = np.zeros(n_frames, dtype=np.float32)
        for i in range(n_frames):
            seg = y[i * hop: i * hop + frame].astype(np.float64)
            seg = seg - seg.mean()
            ac = np.correlate(seg, seg, mode="full")[frame - 1:]
            if ac[0] <= 1e-8:
                continue
            ac = ac / ac[0]
            lag = lag_min + int(np.argmax(ac[lag_min:lag_max]))
            if ac[lag] > 0.3:
                f0[i] = self.sample_rate / lag
        return f0

    # -- silence handling --------------------------------------------------

    def trim_silence(self, y: np.ndarray) -> np.ndarray:
        """Trim leading/trailing silence below trim_db (TTS/utils/audio.py:311-316),
        with the reference's 0.01 s margin."""
        margin = int(self.sample_rate * 0.01)
        y = y[margin:-margin] if len(y) > 2 * margin else y
        frame = self.win_length
        hop = self.hop_length
        if len(y) < frame:
            return y
        n_frames = 1 + (len(y) - frame) // hop
        idx = np.arange(n_frames)[:, None] * hop + np.arange(frame)[None, :]
        rms = np.sqrt(np.mean(y[idx] ** 2, axis=-1) + 1e-12)
        ref = np.max(rms)
        db = 20.0 * np.log10(np.maximum(rms / max(ref, 1e-10), 1e-10))
        keep = np.where(db > -self.trim_db)[0]
        if len(keep) == 0:
            return y
        start = keep[0] * hop
        end = min(len(y), keep[-1] * hop + frame)
        return y[start:end]

    def find_endpoint(self, y: np.ndarray, threshold_db: float = -40.0,
                      min_silence_sec: float = 0.8) -> int:
        window = int(self.sample_rate * min_silence_sec)
        hop = window // 4
        thresh = self._db_to_amp(np.array(threshold_db))
        for x in range(hop, len(y) - window, hop):
            if np.max(np.abs(y[x: x + window])) < thresh:
                return x + hop
        return len(y)

    # -- mu-law / quantization --------------------------------------------

    @staticmethod
    def mulaw_encode(y: np.ndarray, qc: int) -> np.ndarray:
        mu = qc - 1
        signal = np.sign(y) * np.log1p(mu * np.abs(y)) / np.log1p(mu)
        return np.floor((signal + 1) / 2 * mu + 0.5)

    @staticmethod
    def mulaw_decode(y: np.ndarray, qc: int) -> np.ndarray:
        mu = qc - 1
        x = y / mu * 2.0 - 1.0
        return np.sign(x) * (np.expm1(np.abs(x) * np.log1p(mu))) / mu

    @staticmethod
    def quantize(y: np.ndarray, bits: int) -> np.ndarray:
        return np.clip((y + 1.0) * (2**bits - 1) / 2, 0, 2**bits - 1)

    @staticmethod
    def dequantize(y: np.ndarray, bits: int) -> np.ndarray:
        return 2 * y / (2**bits - 1) - 1

    # -- wav IO ------------------------------------------------------------

    def load_wav(self, path: str, sr: Optional[int] = None) -> np.ndarray:
        y, file_sr = read_wav(path)
        target = sr or self.sample_rate
        if file_sr != target:
            y = resample(y, file_sr, target)
        if self.do_trim_silence:
            y = self.trim_silence(y)
        if self.do_sound_norm:
            y = y / (np.abs(y).max() + 1e-8) * 0.95
        return y

    def save_wav(self, y: np.ndarray, path: str) -> None:
        write_wav(path, y, self.sample_rate)


# ---------------------------------------------------------------------------
# WAV helpers (stdlib `wave`; no soundfile/scipy.io dependency)
# ---------------------------------------------------------------------------

def read_wav(path_or_bytes) -> Tuple[np.ndarray, int]:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        f = wave.open(io.BytesIO(path_or_bytes), "rb")
    else:
        f = wave.open(path_or_bytes, "rb")
    with f:
        sr = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        ch = f.getnchannels()
        raw = f.readframes(n)
    if width == 2:
        y = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        y = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        y = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported wav sample width: {width}")
    if ch > 1:
        y = y.reshape(-1, ch).mean(axis=1)
    return y, sr


def write_wav(path, y: np.ndarray, sample_rate: int) -> None:
    y = np.asarray(y, dtype=np.float32)
    peak = np.abs(y).max()
    if peak > 1.0:
        y = y / peak
    data = (y * 32767.0).astype("<i2").tobytes()
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(data)


def wav_to_bytes(y: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    write_wav(buf, y, sample_rate)
    return buf.getvalue()


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase-free FFT resampling (scipy.signal.resample equivalent)."""
    if orig_sr == target_sr:
        return y
    from math import gcd

    g = gcd(orig_sr, target_sr)
    n_out = int(round(len(y) * target_sr / orig_sr))
    spec = np.fft.rfft(y)
    if target_sr < orig_sr:
        cutoff = int(len(spec) * target_sr / orig_sr)
        spec = spec[:cutoff]
    out_spec = np.zeros(n_out // 2 + 1, dtype=spec.dtype)
    k = min(len(spec), len(out_spec))
    out_spec[:k] = spec[:k]
    del g
    return (np.fft.irfft(out_spec, n=n_out) * (target_sr / orig_sr)).astype(np.float32)
