"""The size cost of the port's checkpoints against orbax's.

The port writes zstd frames of raw blocks (it has no compressor); orbax,
under the JAX package's ``save_checkpoint``, writes level-1 zstd frames.
This writes the same leaves both ways and prints the bytes of each
directory: a bf16 weight drawn as debug://7b draws its projections
(normal, std 0.02, 4,096 x 4,096) and a float32 one (normal, std 1).

    python scripts/torch_orbax_size_cost.py      # needs JAX and orbax; CPU
"""

import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import orbax.checkpoint as ocp

    from matryoshka_mm_torch.utils.orbax_io import write_tree

    gen = torch.Generator().manual_seed(0)
    leaves = {
        "bf16, normal(0, 0.02)": (torch.randn(4096, 4096, generator=gen)
                                  * 0.02).bfloat16(),
        "float32, normal(0, 1)": torch.randn(2048, 4096, generator=gen),
    }
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, t) in enumerate(leaves.items()):
            a = t.view(torch.int16).numpy().view(jax.numpy.bfloat16) \
                if t.dtype == torch.bfloat16 else t.numpy()
            jdir, tdir = Path(tmp, f"orbax{i}"), Path(tmp, f"port{i}")
            ckptr = ocp.StandardCheckpointer()
            ckptr.save(os.path.abspath(jdir), {"w": np.asarray(a)})
            ckptr.wait_until_finished()
            write_tree(str(tdir), {"w": t})
            raw = t.numel() * t.element_size()
            j, p = _bytes(jdir), _bytes(tdir)
            print(f"{name} {tuple(t.shape)}: {raw} bytes; orbax (level-1 "
                  f"zstd) {j} bytes ({j / raw:.3f}); the port (raw blocks) "
                  f"{p} bytes ({p / raw:.3f}); the port's / orbax's "
                  f"{p / j:.3f}")


if __name__ == "__main__":
    main()
