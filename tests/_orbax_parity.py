"""What the tests of the orbax reader share (tests/test_torch_orbax*.py):
trees built from the port's own init through the JAX package's bridge
(`motif_tpu.checkpoint.port_torch_state_dict`, no JAX `init`), train states
saved by `motif_tpu.checkpoint.save_train_state`, and a leaf-for-leaf
comparison of `read_orbax_tree` with orbax's raw restore.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import torch

from motif_tpu import checkpoint as jckpt
from motif_tpu.trainer import TrainState
from motif_tpu_torch.models.motif import build_motif


def full_width_params(dtype=np.float32, seed: int = 0) -> dict:
    """The flax params tree of the full-width Ours (setting 5, channel 64,
    5 + 40 blocks) drawn by the port's init from `seed`, as numpy."""
    m = build_motif(device="cpu", seed=seed)
    with jax.enable_x64(dtype == np.float64):
        tree = jckpt.port_torch_state_dict(m.state_dict())
    return jax.tree.map(lambda a: np.asarray(a, dtype), tree)


def optax_state(params: dict, weight_decay: float, seed: int = 1,
                step: int = 7) -> TrainState:
    """A TrainState of `params` whose Adam (AdamW with a weight decay)
    moments are seeded numpy values (nu >= 0) and whose counts and step are
    `step`, in the JAX package's optimiser layout
    (motif_tpu/trainer.py:72-78)."""
    from motif_tpu.trainer import TrainerConfig, make_optimizer

    tx, _ = make_optimizer(TrainerConfig(weight_decay=weight_decay))
    rng = np.random.default_rng(seed)
    p = jax.tree.map(jnp.asarray, params)
    opt = tx.init(p)
    adam = opt[0]._replace(
        count=jnp.asarray(step, jnp.int32),
        mu=jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape) * 1e-3, a.dtype), p),
        nu=jax.tree.map(lambda a: jnp.asarray(
            rng.random(a.shape) * 1e-6, a.dtype), p))
    sched = opt[-1]._replace(count=jnp.asarray(step, jnp.int32))
    opt = (adam,) + tuple(opt[1:-1]) + (sched,)
    return TrainState(params=p, opt_state=opt,
                      step=jnp.asarray(step, jnp.int32))


def orbax_restore(path: str):
    with ocp.StandardCheckpointer() as c:
        return c.restore(str(path))


def flat(tree, at=()):
    """{key path: leaf} of a tree of dicts and sequences (an index as its
    decimal string); an empty container or None is a leaf."""
    if isinstance(tree, dict) and tree:
        return {p: v for k, t in tree.items() for p, v in flat(
            t, at + (k,)).items()}
    if isinstance(tree, (list, tuple)) and tree:
        return {p: v for i, t in enumerate(tree) for p, v in flat(
            t, at + (str(i),)).items()}
    return {at: tree}


def raw(leaf) -> tuple:
    """(dtype name, shape, bytes) of an array leaf: a torch.bfloat16 tensor
    and a JAX / numpy bfloat16 array alike as their uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        assert leaf.dtype == torch.bfloat16, leaf.dtype
        a = leaf.view(torch.int16).numpy().view(np.uint16)
        return "bfloat16", a.shape, a.tobytes()
    a = np.asarray(leaf)
    name = a.dtype.name
    if name == "bfloat16":
        a = a.view(np.uint16)
    return name, a.shape, np.ascontiguousarray(a).tobytes()


def sha256(leaf) -> str:
    return hashlib.sha256(raw(leaf)[2]).hexdigest()


def assert_same_tree(got, want) -> int:
    """`read_orbax_tree`'s tree against orbax's raw restore: the same
    containers (dict / list) at the same keys, every array leaf of the same
    dtype, shape and bytes, every other leaf equal. Returns the number of
    array leaves."""
    g, w = flat(got), flat(want)
    assert set(g) == set(w), (sorted(set(g) ^ set(w)))[:10]
    n = 0
    for path, b in w.items():
        a = g[path]
        if b is None or isinstance(b, (dict, list, tuple, int, float)):
            assert a == b and type(a) is type(b), (path, a, b)
            continue
        assert raw(a) == raw(b), path
        n += 1
    _same_containers(got, want, ())
    return n


def _same_containers(a, b, at):
    if isinstance(b, (dict, list, tuple)):
        assert type(a) is type(b), (at, type(a), type(b))
    if isinstance(b, dict):
        for k in b:
            _same_containers(a[k], b[k], at + (k,))
    elif isinstance(b, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same_containers(x, y, at + (i,))


# the resumed step: tests/test_torch_trainer.py's cut widths and tolerances
CH, FRONT, BACK = 16, 1, 2
B, N, LR, HR = 1, 2, 16, 64
ITERS = 1
B1 = 0.9
LOSS_RTOL = 1e-9
GRAD_TOL = 1e-10


def _perturb_offsets(tree, rng):
    out = {}
    for k, v in tree.items():
        if k == "conv_offset_mask":
            out[k] = {"kernel": rng.standard_normal(v["kernel"].shape) * 0.05,
                      "bias": rng.standard_normal(v["bias"].shape) * 1.5}
        elif isinstance(v, dict):
            out[k] = _perturb_offsets(v, rng)
        else:
            out[k] = v
    return out


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"lq": rng.random((B, 4, LR, LR, 3)),
            "gt": rng.random((B, N + 2, HR, HR, 3)),
            "times": np.sort(rng.random((B, N)), -1)}


def resume_steps(weight_decay: float, ckpt_dir: str) -> dict:
    """motif_tpu's Trainer (Adam, AdamW with a weight decay) takes two
    optax steps from step 1 in float64 and saves at step 3; then
    motif_tpu's `restore_train_state` and the port's each take one more
    step from that directory, on the same batch.

    teacher_forcing_steps = 1 makes every draw use_gt = False from step 1
    on (one compiled JAX step). Returns {"jax": (aux, gradient tree, mu,
    nu, params after the step), "port": (aux, grads, trainer),
    "restored": the port's optimiser state right after the restore}."""
    from motif_tpu.models.motif import MoTIF as JMoTIF
    from motif_tpu.parallel import make_mesh, replicate
    from motif_tpu import trainer as jtrainer
    from motif_tpu_torch import checkpoint as tckpt
    from motif_tpu_torch.models.motif import MoTIF
    from motif_tpu_torch.trainer import Trainer, TrainerConfig

    torch.manual_seed(0)
    with jax.enable_x64(True):
        params = jax.tree.map(np.asarray, jckpt.port_torch_state_dict(
            MoTIF(CH, FRONT, BACK).double().state_dict()))
    params = _perturb_offsets(params, np.random.default_rng(7))
    params["alpha"] = np.full((1,), 0.5)
    cfg = dict(teacher_forcing_steps=1, weight_decay=weight_decay)
    with jax.enable_x64(True):
        tr = jtrainer.Trainer(JMoTIF(setting=5, channel=CH, front_rbs=FRONT,
                                     back_rbs=BACK),
                              jtrainer.TrainerConfig(**cfg), iters=ITERS,
                              mesh=make_mesh(1), seed=0)
        p = jax.tree.map(jnp.asarray, params)
        state = jax.device_put(jtrainer.TrainState(
            params=p, opt_state=tr.tx.init(p),
            step=jnp.asarray(1, jnp.int32)), replicate(tr.mesh))
        tr._host_step = 1
        for seed in (0, 1):
            state, _ = tr.step(state, jax.tree.map(jnp.asarray,
                                                   _batch(seed)))
        jckpt.save_train_state(ckpt_dir, 3, state, meta={"epoch": 0})
        tr._host_step = None          # synced from the restored step
        restored = jckpt.restore_train_state(ckpt_dir, 3, state)
        mu0 = jax.tree.map(np.asarray, restored.opt_state[0].mu)
        new, jaux = tr.step(restored, jax.tree.map(jnp.asarray, _batch(2)))
        jmu = jax.tree.map(np.asarray, new.opt_state[0].mu)
        jnu = jax.tree.map(np.asarray, new.opt_state[0].nu)
        jgrads = jax.tree.map(lambda a, b: (a - B1 * b) / (1 - B1), jmu, mu0)
        jparams = jax.tree.map(np.asarray, new.params)
        jaux = {k: (v if k == "use_gt" else np.asarray(v))
                for k, v in jaux.items()}

    torch.manual_seed(1)              # weights the restore must replace
    port = Trainer(MoTIF(CH, FRONT, BACK).double(), TrainerConfig(**cfg),
                   iters=ITERS, seed=0)
    tckpt.restore_train_state(ckpt_dir, 3, port)
    restored_opt = {k: {n: (t.clone() if isinstance(t, torch.Tensor) else t)
                        for n, t in s.items()}
                    for k, s in port.optimizer.state_dict()["state"].items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        aux = port.step(_batch(2))
    finally:
        torch.set_num_threads(threads)
    grads = {k: p.grad.detach().clone()
             for k, p in port.model.named_parameters()}
    return {"jax": (jaux, jgrads, jmu, jnu, jparams),
            "port": (aux, grads, port), "restored": restored_opt}


def check_resumed_step(steps: dict) -> None:
    """The resumed steps of `resume_steps`: the port resumed at step 3 with
    optax's count 2 per parameter; the same draw, lr, loss and parts
    (1e-9) and gradients (1e-10 of each tensor's largest |g|); the moments
    after the step within 1e-10 of each tensor's largest."""
    from motif_tpu_torch import checkpoint as tckpt

    jaux, jgrads, jmu, jnu, jparams = steps["jax"]
    aux, grads, port = steps["port"]
    assert port.step_count == 4
    names = [n for n, _ in port.model.named_parameters()]
    assert len(steps["restored"]) == len(names)
    for s in steps["restored"].values():
        assert float(s["step"]) == 2.0 and s["step"].dtype == torch.float32
    assert jaux["use_gt"] is aux["use_gt"] is False
    for k in ("loss", "l_pix", "flow_l"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert np.float32(aux["lr"]) == np.float32(jaux["lr"])

    def held(got: dict, want_tree, tol, what):
        want = tckpt.state_dict_from_flax(want_tree, got.keys())
        for k, g in got.items():
            w = want[k].numpy()
            scale = max(float(np.abs(w).max()), 1e-300)
            err = float(np.abs(g.detach().numpy() - w).max()) / scale
            assert err <= tol, (what, k, err)

    held(grads, jgrads, GRAD_TOL, "grad")
    opt = port.optimizer.state_dict()["state"]
    held({n: opt[i]["exp_avg"] for i, n in enumerate(names)}, jmu,
         GRAD_TOL, "exp_avg")
    held({n: opt[i]["exp_avg_sq"] for i, n in enumerate(names)}, jnu,
         GRAD_TOL, "exp_avg_sq")


def check_resumed_update(steps: dict, ckpt_dir: str, weight_decay: float):
    """The update from motif_tpu's own gradients: a second port trainer
    restored from the directory, given motif_tpu's gradients of the resumed
    step, steps to motif_tpu's parameters within 1e-12 of each tensor's
    largest |update| plus 2 ulps of its largest |weight| (torch's AdamW
    decays the weight apart from the Adam update, optax adds both into one
    update)."""
    from motif_tpu_torch import checkpoint as tckpt
    from motif_tpu_torch.models.motif import MoTIF
    from motif_tpu_torch.trainer import Trainer, TrainerConfig

    _, jgrads, _, _, jparams = steps["jax"]
    torch.manual_seed(2)
    tr = Trainer(MoTIF(CH, FRONT, BACK).double(), TrainerConfig(
        teacher_forcing_steps=1, weight_decay=weight_decay), iters=ITERS)
    tckpt.restore_train_state(ckpt_dir, 3, tr)
    before = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    g = tckpt.state_dict_from_flax(jgrads, before.keys())
    for k, p in tr.model.named_parameters():
        p.grad = g[k].clone()
    for group in tr.optimizer.param_groups:
        group["lr"] = float(tr.schedule(tr.step_count))
    tr.optimizer.step()
    want = tckpt.state_dict_from_flax(jparams, before.keys())
    for k, p in tr.model.named_parameters():
        w = want[k].numpy()
        update = float(np.abs(w - before[k].numpy()).max())
        err = float(np.abs(p.detach().numpy() - w).max())
        tol = 1e-12 * update + 2 * np.spacing(float(np.abs(w).max()))
        assert err <= tol, (k, err, update)
