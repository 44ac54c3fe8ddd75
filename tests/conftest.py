"""Test configuration: run everything on a virtual 8-device CPU mesh.

Mirrors the driver's multi-chip dry-run environment
(XLA_FORCE_HOST_PLATFORM_DEVICE_COUNT) so sharding tests exercise real
GSPMD partitioning without TPU hardware.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
# Physics conformance math is validated in f64 before f32/bf16 tuning.
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

# The container pins jax_platforms programmatically (env var alone is
# ignored) — force CPU for the test mesh.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: physics step compiles are expensive on the
# single-core CPU runner; cache them across test runs.
jax.config.update("jax_compilation_cache_dir", "/root/repo/.jax_cache")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


# ---------------------------------------------------------------------------
# Test tiers. `pytest -m fast` is the per-commit gate: a <10-minute (warm
# compile cache) subset covering the engine core — math, smooth dynamics,
# contacts, constraint/collision kernels, conformance vs MuJoCo 3, and the
# wrapper layer. Everything env-zoo/vision/distributed is `slow`; the full
# suite is the per-round gate. Keep FAST_FILES' warm wall time under 10 min
# when adding tests (timings: PROFILE.md "test tiers" note).
# ---------------------------------------------------------------------------

import pytest  # noqa: E402

FAST_FILES = {
    "test_rotation.py",        # ~15 s warm
    "test_icp.py",             # ~15 s
    "test_randomization.py",   # ~20 s
    "test_regrasp.py",         # ~10 s
    "test_force_limiter.py",   # ~10 s
    "test_physics.py",         # ~90 s
    "test_conformance.py",     # ~70 s
    "test_boxbox_kernel.py",   # \
    "test_cg_kernel.py",       #  | ~85 s together
    "test_factor_kernel.py",   #  |
    "test_constraint_batched.py",  # /
    "test_convex_kernel.py",   # ~40 s
    "test_wrappers.py",        # ~130 s (locked-env fixture build)
    "test_f32_tier.py",        # ~100 s
}


def pytest_configure(config):
    config.addinivalue_line("markers", "fast: per-commit gate (<10 min warm)")
    config.addinivalue_line("markers", "slow: env-zoo/vision/distributed tier")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason where there is none")


def pytest_collection_modifyitems(config, items):
    import os

    for item in items:
        fname = os.path.basename(str(item.fspath))
        tier = pytest.mark.fast if fname in FAST_FILES else pytest.mark.slow
        item.add_marker(tier)
