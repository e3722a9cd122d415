"""Model (`MoTIF.trunk` / `MoTIF.head`) of a serving cell: the work of the
program's plan for the requests served outside the traced slice (each
request at its own N: the trunk once, the head once a padded chunk,
counted over the serving reference and split by dtype, `traffic/
clips_serve.py`), each FLOP at its dtype's peak (bfloat16 on the tensor
cores, float32 outside them), over their time, in percent."""

from benchmark.metrics._common import untraced


def read(rec):
    plan = rec.get("plan_flops_of_n")
    rows = untraced(rec, rec["requests"])
    if not plan or not rows:
        return None
    ideal = sum(plan[r["n"]]["bf16"] / rec["peak_bf16"]
                + plan[r["n"]]["fp32"] / rec["peak"] for r in rows)
    seconds = sum(r["ms"] for r in rows) / 1e3
    return 100.0 * ideal / seconds
