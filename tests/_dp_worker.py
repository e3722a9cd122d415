"""The process of a data-parallel step on the CPU, spawned by
tests/_parallel_parity.py: it imports torch and motif_tpu_torch only (no
JAX), joins a gloo group through a file under the test's directory (no
port, so that test workers never share one), takes one optimiser step of
the port's Trainer on its contiguous share of the global batch and writes
what it holds after the step: the loss, every gradient (summed over the
ranks by the Trainer) and every parameter."""

import torch
import torch.distributed as tdist


def run(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                             rank=rank, world_size=world)
    try:
        from motif_tpu_torch.models.motif import MoTIF
        from motif_tpu_torch.trainer import Trainer, TrainerConfig

        spec = torch.load(f"{tmp}/spec.pt")
        model = MoTIF(**spec["model"]).double()
        model.load_state_dict(spec["state"])
        tr = Trainer(model, TrainerConfig(teacher_forcing_steps=1),
                     out_hw=None, iters=1, seed=0, family=spec["family"])
        tr.step_count = 1
        share = spec["batch"]["lq"].shape[0] // world
        batch = {k: v[rank * share:(rank + 1) * share]
                 for k, v in spec["batch"].items()}
        aux = tr.step(batch)
        torch.save({"aux": {k: (float(v) if isinstance(v, torch.Tensor)
                                else v) for k, v in aux.items()},
                    "grads": {k: p.grad for k, p in model.named_parameters()},
                    "params": {k: p.detach() for k, p in
                               model.named_parameters()},
                    "world": tdist.get_world_size(), "sync": tr.sync,
                    "next_draw": tr._rng.random()},
                   f"{tmp}/rank{rank}.pt")
    finally:
        tdist.destroy_process_group()
