"""Write the small orbax train state that tests/test_torch_orbax_fixture.py
and chip_smoke.py read with `motif_tpu_torch.checkpoint.read_orbax_tree`,
and the list of its leaves as orbax's own restore gives them.

    JAX_PLATFORMS=cpu python tools/make_orbax_fixture.py \
        [--out tests/fixtures/orbax_state]

The state is a `motif_tpu.trainer.TrainState` after two optax steps of
the JAX package's own optimiser (`motif_tpu.trainer.make_optimizer` with a
weight decay: AdamW, its state (scale_by_adam, add_decayed_weights,
the schedule)) on a quadratic loss, saved by
`motif_tpu.checkpoint.save_train_state` as `<out>/step_2` with a
`.meta.json` sidecar. Its params hold float32 and bfloat16 leaves; its
counts and step are int32 scalars; `params/big` (64 x 64 float32, 16 KiB
after zstd) is above orbax's 1024-byte inline limit, so it and its
moments are stored out of line in a data file.

`<out>/leaves.json` lists each leaf of `ocp.StandardCheckpointer()
.restore` by key path (a sequence index as its decimal string): dtype,
shape, and the sha256 of its bytes in C order (a bfloat16 leaf's as
uint16), and the OCDBT keys whose values tensorstore stores out of line
(`tensorstore.ocdbt.dump` of the root B+tree node).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2


def _params(rng):
    import jax.numpy as jnp

    return {"conv": {"kernel": jnp.asarray(rng.standard_normal((3, 3, 4, 8)),
                                           jnp.float32),
                     "bias": jnp.asarray(rng.standard_normal(8), jnp.float32)},
            "dense": {"kernel": jnp.asarray(rng.standard_normal((16, 4)),
                                            jnp.bfloat16),
                      "bias": jnp.asarray(rng.standard_normal(4),
                                          jnp.bfloat16)},
            "big": jnp.asarray(rng.standard_normal((64, 64)), jnp.float32)}


def leaf_rows(tree, path=()):
    """[(key path, dtype, shape, sha256)] of a restored tree, in key order;
    None leaves (optax's empty states) are listed with dtype None."""
    import numpy as np

    if isinstance(tree, dict):
        return [r for k in sorted(tree) for r in leaf_rows(tree[k],
                                                           path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [r for i, v in enumerate(tree)
                for r in leaf_rows(v, path + (str(i),))]
    if tree is None:
        return [{"path": list(path), "dtype": None, "shape": None,
                 "sha256": None}]
    a = np.asarray(tree)
    raw = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return [{"path": list(path), "dtype": a.dtype.name,
             "shape": list(a.shape),
             "sha256": hashlib.sha256(np.ascontiguousarray(raw).tobytes())
             .hexdigest()}]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(ROOT, "tests", "fixtures",
                                                  "orbax_state"))
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import orbax.checkpoint as ocp
    import tensorstore as ts

    from motif_tpu import checkpoint
    from motif_tpu.trainer import TrainerConfig, TrainState, make_optimizer

    jax.config.update("jax_platforms", "cpu")
    tx, _ = make_optimizer(TrainerConfig(lr=1e-2, weight_decay=1e-2))
    params = _params(np.random.default_rng(0))
    target = jax.tree.map(lambda a: a * 0.5, params)

    def loss(p):
        return sum(jnp.sum((a.astype(jnp.float32) - b.astype(jnp.float32))
                           ** 2) for a, b in zip(jax.tree.leaves(p),
                                                 jax.tree.leaves(target)))

    state = TrainState(params=params, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    for _ in range(STEPS):
        grads = jax.grad(loss)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        state = TrainState(params=optax.apply_updates(state.params, updates),
                           opt_state=opt_state, step=state.step + 1)

    if os.path.isdir(args.out):
        shutil.rmtree(args.out)
    checkpoint.save_train_state(args.out, STEPS, state, meta={"epoch": 0})
    step_dir = os.path.join(args.out, f"step_{STEPS}")
    with ocp.StandardCheckpointer() as c:
        restored = c.restore(step_dir)
    base = ts.KvStore.open(f"file://{step_dir}/").result()
    manifest = ts.ocdbt.dump(base).result()
    root = ts.ocdbt.dump(base, manifest["versions"][-1]["root"]["location"]
                         ).result()
    out_of_line = sorted(e["key"].decode() for e in root["entries"]
                         if "indirect_value" in e)
    head = json.dumps({"step_dir": f"step_{STEPS}", "orbax": ocp.__version__,
                       "out_of_line": out_of_line})
    rows = ",\n  ".join(json.dumps(r) for r in leaf_rows(restored))
    with open(os.path.join(args.out, "leaves.json"), "w") as f:
        f.write(f'{head[:-1]},\n "leaves": [\n  {rows}\n ]}}\n')
    print(f"wrote {step_dir}: {len(leaf_rows(restored))} leaves, out of "
          f"line {out_of_line}")


if __name__ == "__main__":
    main()
