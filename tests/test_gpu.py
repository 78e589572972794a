"""Card-only tests (marker ``gpu``): what a CPU run cannot show.

They skip on the CPU test backend; ``python chip_smoke.py`` runs them on
the GPU inside its own process.  Whether a GPU is present is decided in the
fixture, never at import, so every xdist worker collects the same tests.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU (backend is {d.platform}); run via chip_smoke.py")
    return d


def test_highest_f32_matmul_is_full_precision(gpu):
    """Precision.HIGHEST keeps f32 products out of TF32: a 512-term f32
    dot matches the f64 product to f32 rounding, not TF32's ~1e-3."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((256, 512))
    b = rng.standard_normal((512, 256))
    ref = a @ b
    got = jnp.matmul(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32),
                     precision=jax.lax.Precision.HIGHEST)
    err = np.max(np.abs(np.asarray(got, np.float64) - ref)) / np.abs(ref).max()
    assert err < 1e-5, err


def test_f64_is_native(gpu):
    """f64 arrays stay f64 on the card (x64 is the library's contract)."""
    x = jnp.linspace(0.0, 1.0, 1 << 20, dtype=jnp.float64)
    s = float(jnp.sum(x * x))
    n = (1 << 20) - 1
    exact = (n * (n + 1) * (2 * n + 1) / 6) / n**2
    assert x.dtype == jnp.float64
    assert abs(s - exact) / exact < 1e-12


def test_device_memory_stats(gpu):
    """The card reports the peak-memory counter the benchmark reads."""
    jnp.ones((1024, 1024)).block_until_ready()
    stats = gpu.memory_stats()
    assert stats["peak_bytes_in_use"] > 0 and stats["bytes_limit"] > 0
