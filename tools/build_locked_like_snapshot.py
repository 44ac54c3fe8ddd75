"""Compile the locked-like world with the JAX package's compiler and write
its snapshot, `robogym_torch/worlds/locked_like.npz`.

    JAX_PLATFORMS=cpu python tools/build_locked_like_snapshot.py

The port loads the snapshot with `robogym_torch.bridge.model_from_numpy`; a test
rebuilds it and checks that it matches the committed file field by field.
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compile_snapshot():
    """{key: array} of the freshly compiled world (float32 model)."""
    import jax.numpy as jnp

    from robogym_torch.bridge import model_to_numpy
    from robogym_torch.worlds import locked_like
    from robogym_tpu.mjcf.compiler import compile_xml

    with tempfile.TemporaryDirectory() as tmp:
        model = compile_xml(locked_like.write(tmp), dtype=jnp.float32)
    return model, model_to_numpy(model)


def main():
    from robogym_torch.worlds import locked_like

    _, arrays = compile_snapshot()
    np.savez_compressed(locked_like.SNAPSHOT, **arrays)
    print(locked_like.SNAPSHOT, os.path.getsize(locked_like.SNAPSHOT), "bytes")


if __name__ == "__main__":
    main()
