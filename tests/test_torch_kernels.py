"""The port's two kernels, K1 (limiter front end) and K2 (first-order IIR
scan), through their plain twins on the CPU.

The CUDA kernels themselves run only on a card: ``chip_smoke.py`` holds
each against its twin there.  Here the twins are held against the JAX
package (K1's Pallas kernel in interpret mode) and scipy at float64, and
the wrappers are checked to import without ``nvcc`` and to raise, never
fall back to the twin, when asked to launch without a kernel library.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal

import matchering_tpu.ops.pallas_envelope as pe
from matchering_tpu.ops import iir as jiir
from matchering_tpu_torch.kernels import build, envelope, scan
from matchering_tpu_torch.ops import iir

THRESHOLD = 0.998138427734375  # Config().threshold
FS = 44100

# the limiter's three default poles (Config().limiter, hyrax.py:48-75)
FILTERS = {
    "attack": (iir.one_pole_filter(-2.0, 44), jiir.one_pole_filter(-2.0, 44)),
    "hold": (iir.butter1_coefficients(7.0, FS), jiir.butter1_coefficients(7.0, FS)),
    "release": (
        iir.butter1_coefficients(800.0 / 3000.0, FS),
        jiir.butter1_coefficients(800.0 / 3000.0, FS),
    ),
}


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def interpreted():
    """Run pallas_call in interpreter mode (the pattern of test_pallas.py)."""
    orig = pe.pl.pallas_call

    def interp(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    with mock.patch.object(pe.pl, "pallas_call", interp):
        yield


class TestEnvelopeTwin:
    @pytest.mark.parametrize("n", [33000, 70001])
    def test_matches_pallas_kernel(self, interpreted, rng, n):
        x = rng.randn(n, 2) * 0.6
        gain, slided = envelope.limiter_front_end(t(x), THRESHOLD, 44)
        jgain, jslided = pe.limiter_front_end(jnp.asarray(x), THRESHOLD, 44)
        np.testing.assert_allclose(gain.numpy(), np.asarray(jgain), rtol=0, atol=1e-12)
        np.testing.assert_allclose(slided.numpy(), np.asarray(jslided), rtol=0, atol=1e-12)

    def test_quiet_signal_zero_gain(self, rng):
        gain, slided = envelope.limiter_front_end(t(rng.randn(5000, 2) * 0.1), THRESHOLD, 44)
        assert float(gain.abs().max()) == 0.0 and float(slided.abs().max()) == 0.0


class TestScanTwin:
    @pytest.mark.parametrize("pole", sorted(FILTERS))
    def test_lfilter_matches_jax_and_scipy(self, rng, pole):
        filt, jfilt = FILTERS[pole]
        x = rng.rand(20_000)
        got = iir.lfilter_first_order(filt, t(x), zi=t(np.array([0.3]))).numpy()
        want = np.asarray(jiir.lfilter_first_order(jfilt, jnp.asarray(x), zi=0.3))
        ref, _ = signal.lfilter([filt.b0, filt.b1], [1.0, filt.a1], x, zi=[0.3])
        np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-12)
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)

    @pytest.mark.parametrize("pole", sorted(FILTERS))
    def test_filtfilt_matches_jax_and_scipy(self, rng, pole):
        filt, jfilt = FILTERS[pole]
        x = rng.rand(20_001)
        got = iir.filtfilt_first_order(filt, t(x)).numpy()
        want = np.asarray(jiir.filtfilt_first_order(jfilt, jnp.asarray(x)))
        ref = signal.filtfilt([filt.b0, filt.b1], [1.0, filt.a1], x)
        np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-12)
        np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-12)

    @pytest.mark.parametrize("n", [1, 200, 256, 257, 70_001])
    def test_rows_and_reverse(self, rng, n):
        filt = FILTERS["release"][0]
        b, a = [filt.b0, filt.b1], [1.0, filt.a1]
        x = rng.rand(3, n)
        zi = rng.rand(3)
        forward = scan.first_order_filter(t(x), *filt, zi=t(zi)).numpy()
        backward = scan.first_order_filter(t(x), *filt, zi=t(zi), reverse=True).numpy()
        for r in range(3):
            ref, _ = signal.lfilter(b, a, x[r], zi=[zi[r]])
            np.testing.assert_allclose(forward[r], ref, rtol=1e-11, atol=1e-12)
            ref, _ = signal.lfilter(b, a, x[r, ::-1], zi=[zi[r]])
            np.testing.assert_allclose(backward[r], ref[::-1], rtol=1e-11, atol=1e-12)

    def test_float32_io_keeps_float64_state(self, rng):
        filt = FILTERS["release"][0]
        x = rng.rand(50_000)
        got = scan.first_order_filter(t(x.astype(np.float32)), *filt)
        assert got.dtype == torch.float32
        ref, _ = signal.lfilter(
            [filt.b0, filt.b1], [1.0, filt.a1], x.astype(np.float32).astype(np.float64),
            zi=[0.0],
        )
        # only the final rounding to float32 separates the two
        np.testing.assert_allclose(got.numpy(), ref, rtol=2**-23, atol=0)


class TestKernelWrappers:
    def test_modules_import_without_nvcc(self, monkeypatch, tmp_path):
        import importlib

        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        for module in (build, envelope, scan):
            importlib.reload(module)
        with pytest.raises(RuntimeError, match="nvcc"):
            build._nvcc()

    @pytest.mark.parametrize("kernel", ["envelope", "scan"])
    def test_cuda_tensor_raises_instead_of_running_the_twin(
        self, monkeypatch, tmp_path, kernel
    ):
        """A CUDA tensor goes to the kernel: without a kernel library the
        wrapper raises, and the twin is never called."""

        def no_nvcc():
            raise RuntimeError("nvcc not found")

        monkeypatch.setattr(build, "_library", None)
        monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
        monkeypatch.setattr(build, "_nvcc", no_nvcc)
        fake = mock.MagicMock(spec=torch.Tensor)
        fake.device = torch.device("cuda", 0)
        fake.dtype = torch.float32
        fake.ndim = 2
        fake.shape = (4096, 2)
        fake.is_contiguous.return_value = True
        twin = mock.MagicMock()
        if kernel == "envelope":
            monkeypatch.setattr(envelope, "limiter_front_end_plain", twin)
            call = lambda: envelope.limiter_front_end(fake, THRESHOLD, 44)  # noqa: E731
        else:
            monkeypatch.setattr(scan, "first_order_filter_plain", twin)
            call = lambda: scan.first_order_filter(fake, 0.5, 0.0, -0.5)  # noqa: E731
        with pytest.raises(RuntimeError, match="nvcc"):
            call()
        twin.assert_not_called()
