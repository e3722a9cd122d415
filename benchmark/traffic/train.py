"""Training steps as `motif_tpu_torch.train.main` drives them: the recipe's
yml (the mix's `datasets` and `train` sections with the configuration's
`network_G`) parsed by the program, `train.setup` (model, loader,
trainer), then `trainer.step` over `device_prefetch(loader.epoch(e))`,
with the loader's thread running. The data is a tree in the dataset's
layout (`tree`: `vimeo` or `adobe`, see data/trees.py) made from the seed
in the run's temporary directory.

Set-up drives the trainer through its first `check_steps` steps (the
warm-up of every shape the window uses); the reference follows those same
steps from the same weights and batches after the window. Mix keys:
`tree` and its sizes, `datasets` / `train` (yml sections), `check_steps`,
`trace_skip` / `trace_steps` (the traced slice)."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np

from benchmark import reference, trace, weights
from benchmark.data import trees

SPANS = ("loader_next", "step", "fwd", "bwd", "opt")


def make_tree(root: str, seed: int, mix: dict) -> dict:
    t = mix["tree"]
    hw = tuple(t["hw"])
    if t["layout"] == "vimeo":
        return trees.vimeo(root, seed, int(t["clips"]), hw, bool(t["flows"]))
    return trees.adobe(root, seed, int(t["clips"]), int(t["frames"]), hw)


def recipe(tmp: str, seed: int, cfg: dict, mix: dict, roots: dict):
    """The recipe's yml, written and parsed by the program's parser."""
    import yaml

    from motif_tpu_torch.utils import config

    train = dict(mix["train"], manual_seed=int(seed) % (2 ** 31))
    data = dict(mix["datasets"]["train"], dataroot_GT=roots["dataroot_GT"],
                dataroot_LQ=roots["dataroot_LQ"])
    opt = {"name": "benchmark", "model": "VideoSR_base", "scale": 4,
           "dataset_ratio": int(mix.get("dataset_ratio", 200)),
           "datasets": {"train": data}, "network_G": dict(cfg["network_G"]),
           "path": {"root": tmp}, "train": train,
           "logger": {"print_freq": 100, "save_checkpoint_freq": 4000}}
    path = os.path.join(tmp, "recipe.yml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return config.parse(path, is_train=True)


def _on_host(batch: dict) -> dict:
    return {k: (v.cpu().numpy() if hasattr(v, "cpu") else v)
            for k, v in batch.items()}


def _leaf_norms(tensors) -> np.ndarray:
    return np.asarray([float(t.double().norm()) for t in tensors])


class _Batches:
    """The loader's batches on the device, epoch after epoch."""

    def __init__(self, loader, device):
        from motif_tpu_torch.data import device_prefetch

        self.loader, self.device, self.epoch = loader, device, 0
        self._prefetch = device_prefetch
        self._open()

    def _open(self):
        self.inner = self.loader.epoch(self.epoch)
        self.it = self._prefetch(self.inner, self.device)

    def next(self):
        try:
            return next(self.it)
        except StopIteration:
            self.close()
            self.epoch += 1
            self._open()
            return next(self.it)

    def close(self):
        self.it.close()
        self.inner.close()


def run(cell, args, h) -> dict:
    torch = h.torch
    from motif_tpu_torch import train as train_mod

    mix, cfg = cell.traffic, cell.config
    dev = h.device
    _few_threads(torch)
    with tempfile.TemporaryDirectory(prefix="motif_bench_") as tmp:
        roots = make_tree(os.path.join(tmp, "tree"), args.seed, mix)
        h.log("tree made")
        opt = recipe(tmp, args.seed, cfg, mix, roots)
        model, loader, trainer = train_mod.setup(
            opt, dev, dataset_seed=int(args.seed) % (2 ** 31))
        weights.load(model, args.seed, cfg["init"])
        batches = _Batches(loader, dev)
        try:
            rec = _steps(cell, args, h, trainer, batches)
        finally:
            batches.close()
        h.read_memory()
        h.log(f"window done: {rec['attempted']} steps in "
              f"{rec['window_s']:.3f} s")
        del model, trainer, loader, batches
        h.free()
        rec["checks"], rec["flops_per_step"] = compare(
            cell, args, h, rec.pop("first"), roots)
    h.log("checked the first steps against the reference")
    return rec


def _few_threads(torch) -> None:
    """One host thread for torch's and OpenCV's own pools: the step loop and
    the loader's thread then contend with no pool of ours for the cores."""
    import cv2

    torch.set_num_threads(1)
    cv2.setNumThreads(1)


def _step_log(rows: list) -> str:
    """The window's steps by the host clock: median, 90th percentile and
    longest, the time beyond 1.5 medians, and the loader's wait."""
    dur = np.asarray([r["t1"] - r["t0"] for r in rows]) * 1e3
    if not len(dur):
        return "no steps"
    med = float(np.median(dur))
    over = dur[dur > 1.5 * med]
    return (f"step ms median {med:.1f}, p90 {np.percentile(dur, 90):.1f}, "
            f"max {dur.max():.1f}; {len(over)} over 1.5 medians by "
            f"{(over - med).sum():.0f} ms; loader wait "
            f"{sum(r['wait'] for r in rows) * 1e3:.0f} ms")


def _steps(cell, args, h, trainer, batches) -> dict:
    torch = h.torch
    mix, cfg = cell.traffic, cell.config
    b1 = float(mix["train"].get("beta1", 0.9))
    # set-up: the first steps, whose batches, losses, first gradient and
    # change of the weights the reference checks
    n_check = int(mix["check_steps"])
    first = {"batches": [], "loss": []}
    for k in range(n_check):
        batch = batches.next()
        first["batches"].append(_on_host(batch))
        aux = trainer.step(batch)
        first["loss"].append(float(aux["loss"]))
        first["use_gt"] = first.get("use_gt", []) + [bool(aux["use_gt"])]
        if k == 0:
            # the gradient as the optimiser got it: its first moment after
            # one step over (1 - beta1); no state, no gradient
            st = trainer.optimizer.state
            first["grad"] = _leaf_norms(
                st[p]["exp_avg"] / (1 - b1) if "exp_avg" in st.get(p, {})
                else torch.zeros_like(p) for p in trainer.params)
    start = weights.make(args.seed, {n: tuple(p.shape) for n, p in
                                     trainer.model.named_parameters()},
                         cfg["init"], h.device)
    first["change"] = _leaf_norms(p.detach() - start[n] for n, p in
                                  trainer.model.named_parameters())
    del start
    h.sync()
    h.mark_setup()
    h.log(f"set-up done: losses {first['loss']}")

    rows = []
    sl = trace.Slice(torch, h.spans, bool(args.trace),
                     int(mix["trace_skip"]), int(mix["trace_steps"]))
    t_start = time.perf_counter()
    t_stop = t_start + args.seconds
    frames = 0
    while time.perf_counter() < t_stop:
        i = len(rows)
        sl.before(i)
        t0 = time.perf_counter()
        with h.spans("loader_next"):
            batch = batches.next()
        t1 = time.perf_counter()
        with h.spans("step"):
            aux = trainer.step(batch, sync_times=bool(args.trace))
        gt = batch["gt"]
        frames += int(gt.shape[0]) * (int(gt.shape[1]) - 2)
        rows.append({"t0": t0, "t1": time.perf_counter(), "wait": t1 - t0,
                     "ms": aux.get("ms")})
        sl.after(i)
    sl.close()
    h.sync()
    t_end = time.perf_counter()
    window_s = t_end - t_start
    h.log(_step_log(rows))
    return {"attempted": len(rows), "failed": 0, "window_s": window_s,
            "steps": rows, "trace": sl.trace, "trace_host": sl.host,
            "peak": float(cfg["peak_flop_per_s"]), "first": first,
            "setup_s": h.setup_s,
            "e2e": {"train_hr_frames_per_s": frames / window_s}}


def ref_steps(cell, args, h, batches: list, tf32: bool = False,
              half: bool = False, count: bool = False) -> dict:
    """The reference's first steps from the seed's weights on `batches`:
    each step's loss, the first gradient's and the change's norms leaf by
    leaf (and the operations of the first step's forward and backward when
    `count`). `tf32` computes it with TF32 on; `half` leaves out the second
    half of each batch and doubles the loss (the mean over the rest, in
    the recipe's summed loss): the control and a planted fault."""
    torch, dev, cfg, mix = h.torch, h.device, cell.config, cell.traffic
    from benchmark.counts.flops import counting
    from benchmark.reference import infer as ref_infer
    from benchmark.reference import train as ref

    tcfg = mix["train"]
    T = int(tcfg.get("teacher_forcing_steps") or 150000)
    iters = int(cfg["network_G"].get("iters", 12))
    draws = ref.use_gt_draws(int(args.seed) % (2 ** 31), len(batches), T)
    out = {"loss": [], "use_gt": draws, "flops": None}
    with reference.precise(torch, tf32):
        model = ref_infer.build(cfg, dev).train()
        weights.load(model, args.seed, cfg["init"])
        start = [p.detach().clone() for p in model.parameters()]
        opt = ref.Adam(model.parameters(), (float(tcfg.get("beta1", 0.9)),
                                            float(tcfg.get("beta2", 0.99))))
        for k, batch in enumerate(batches):
            b = {key: torch.as_tensor(v, device=dev)
                 for key, v in batch.items()
                 if key in ("lq", "gt", "times", "flow", "flow_gt")}
            if half:
                b = {key: v[:v.shape[0] // 2] for key, v in b.items()}
            for p in model.parameters():
                p.grad = None
            with counting() if count and k == 0 else \
                    contextlib.nullcontext() as c:
                loss = ref.loss(model, b, draws[k], k, iters, T)
                if half:
                    loss = loss * 2.0
                loss.backward()
            if c is not None:
                out["flops"] = c["flops"]
            out["loss"].append(float(loss.detach()))
            if k == 0:
                out["grad"] = _leaf_norms(
                    p.grad if p.grad is not None else torch.zeros_like(p)
                    for p in model.parameters())
            opt.step(ref.lr_at(k, float(tcfg["lr_G"]),
                               float(tcfg["T_period"][0]),
                               float(tcfg["eta_min"])))
            del b, loss
        out["change"] = _leaf_norms(p.detach() - s0 for p, s0 in
                                    zip(model.parameters(), start))
        out["names"] = [n for n, _ in model.named_parameters()]
        del model, opt, start
    h.free()
    return out


def _gap(prog: np.ndarray, ref: np.ndarray, med: float) -> np.ndarray:
    """|prog - ref| over the larger of ref and `med`, leaf by leaf (0 where
    both are 0, inf where only the program's is not)."""
    diff = np.abs(prog - ref)
    den = np.maximum(ref, med)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(den > 0, diff / np.where(den > 0, den, 1.0),
                        np.where(diff > 0, np.inf, 0.0))


def compare(cell, args, h, first: dict, roots: dict):
    """The reference follows the first steps from the seed's weights on
    the same batches. Readings: each step's loss (`loss_rel_first`, and
    `loss_rel`, the worst step), the first gradient's norm leaf by leaf
    (`grad_norm_gap`, the worst leaf) and the weights' change over the
    steps (`change_norm_gap`, the worst leaf, and `change_norm_gap_median`,
    the median leaf), each the gap of the program's norm from the
    reference's over the larger of the reference's and the median leaf's;
    the teacher-forcing draws; and each batch's items made again from the
    files (`item_gap`, reference/items.py). The cell's limits file names
    the readings that are compared; the rest are printed."""
    from benchmark.reference import items

    ref = ref_steps(cell, args, h, first["batches"], count=bool(args.trace))
    grad, change = ref["grad"], ref["change"]
    med = float(np.median(grad))
    g_gap = _gap(first["grad"], grad, med)
    # leaves whose gradient is nought to rounding in the reference move by
    # round-off alone under Adam: left out of the change by this rule
    moved = grad >= 1e-3 * med
    c_med = float(np.median(change[moved]))
    c_gap = _gap(first["change"], change, c_med)[moved]
    names = np.asarray(ref["names"])
    gaps = [abs(a - b) / abs(b) for a, b in zip(first["loss"], ref["loss"])]
    check_items = getattr(items, cell.traffic["tree"]["layout"])
    item_gap = 0.0
    for batch in first["batches"]:
        for j in range(len(batch["key"])):
            item_gap = max(item_gap, check_items(
                {k: v[j] for k, v in batch.items()}, roots["dataroot_GT"],
                roots["dataroot_LQ"]))
    readings = {
        "loss_rel_first": gaps[0], "loss_rel": max(gaps),
        "grad_norm_gap": float(g_gap.max()),
        "change_norm_gap": float(c_gap.max()),
        "change_norm_gap_median": float(np.median(c_gap)),
        "use_gt_mismatch": 0.0 if first["use_gt"] == ref["use_gt"] else 1.0,
        "item_gap": item_gap}
    bad = [f"{n} (program {a!r}, reference {b!r})" for n, a, b in
           zip(names, first["grad"], grad) if not (np.isfinite(a)
                                                   and np.isfinite(b))]
    if bad:
        h.log(f"non-finite first gradients: {bad}")
    h.log(f"readings: {readings}; losses {first['loss']} / {ref['loss']}; "
          f"worst gradient leaf {names[int(np.argmax(g_gap))]}; worst change "
          f"leaf {names[moved][int(np.argmax(c_gap))]} of {int(moved.sum())} "
          f"moved")
    from benchmark.harness import check
    lim = cell.limits["compared"]
    return [check(k, readings[k], lim[k]) for k in lim], ref["flops"]


def control(cell, args, h) -> dict:
    """The control of `correct` (`--control tf32`: the reference with TF32
    on) or a planted fault (`--control half`: half of each batch left out,
    the mean over the rest), put in the program's place for the first
    steps on the loader's batches, then compared as a run compares the
    program."""
    from motif_tpu_torch import train as train_mod

    mix, cfg, dev = cell.traffic, cell.config, h.device
    with tempfile.TemporaryDirectory(prefix="motif_bench_") as tmp:
        roots = make_tree(os.path.join(tmp, "tree"), args.seed, mix)
        opt = recipe(tmp, args.seed, cfg, mix, roots)
        model, loader, _ = train_mod.setup(
            opt, dev, dataset_seed=int(args.seed) % (2 ** 31))
        del model
        batches = _Batches(loader, dev)
        try:
            first = {"batches": [_on_host(batches.next())
                                 for _ in range(int(mix["check_steps"]))]}
        finally:
            batches.close()
        h.mark_setup()
        h.free()
        out = ref_steps(cell, args, h, first["batches"],
                        tf32=args.control == "tf32",
                        half=args.control == "half")
        first.update(loss=out["loss"], grad=out["grad"],
                     change=out["change"], use_gt=out["use_gt"])
        h.read_memory()
        checks, _ = compare(cell, args, h, first, roots)
    return {"setup_s": h.setup_s, "attempted": len(first["batches"]),
            "failed": 0, "checks": checks, "e2e": {}, "window_s": 0.0}
