"""K4 — the port's fused SIREN (motif_tpu_torch.ops.siren_kernel) and the
Siren module against motif_tpu.

On the CPU `siren_mlp` runs its plain version. It is held against the
Pallas kernel `siren_fused` in interpret mode (pallas_call patched as
tests/test_siren_kernel.py does) and against `_composed`, for the three MLP
shapes of the MoTIF path at narrow widths.
The CUDA kernel is held against it on the card in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motif_tpu.models.siren import Siren as JSiren
from motif_tpu.ops import siren_kernel as jsk
from motif_tpu_torch import checkpoint as tckpt
from motif_tpu_torch.models.siren import Siren, hidden_bound, first_bound
from motif_tpu_torch.ops import siren_kernel as tsk

# (in, hidden widths, out): STINF, SINF and synth at channel 16
SHAPES = {"stinf": (19, [64, 64, 256], 3), "sinf": (18, [64, 64, 256], 64),
          "synth": (102, [64, 64, 64, 256], 3)}


@pytest.fixture
def interpret(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(jsk.pl, "pallas_call", patched)


def _mlp(rng, cin, hidden, cout, dtype=np.float64):
    dims = [cin] + list(hidden) + [cout]
    ws = [rng.uniform(-1, 1, (dims[i], dims[i + 1])).astype(dtype)
          * (1.0 / dims[i] if i == 0 else hidden_bound(dims[i], 30.0))
          for i in range(len(dims) - 1)]
    bs = [rng.uniform(-0.1, 0.1, (dims[i + 1],)).astype(dtype)
          for i in range(len(dims) - 1)]
    return ws, bs


def _port_args(x, ws, bs):
    """numpy (in, out) weights → torch (out, in), as nn.Linear stores them."""
    return (torch.from_numpy(x), [torch.from_numpy(w.T.copy()) for w in ws],
            [torch.from_numpy(b) for b in bs])


@pytest.mark.parametrize("name", SHAPES)
@pytest.mark.parametrize("sine_last", [False, True])
def test_plain_matches_pallas_kernel(rng, interpret, name, sine_last):
    """Against siren_fused (Pallas, interpret) in float32: atol 1e-4, the
    float32 rounding of the sums amplified by omega0 = 30 through the
    sines."""
    cin, hidden, cout = SHAPES[name]
    x = rng.uniform(-1, 1, (300, cin)).astype(np.float32)
    ws, bs = _mlp(rng, cin, hidden, cout, np.float32)
    with jax.default_matmul_precision("highest"):
        want = jsk.siren_fused(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                               [jnp.asarray(b) for b in bs], 30.0, sine_last)
    got = tsk.siren_mlp(*_port_args(x, ws, bs), 30.0, sine_last)
    assert got.shape == (300, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("name", SHAPES)
def test_plain_matches_composed(rng, name):
    """Against _composed in float64: atol 1e-10."""
    cin, hidden, cout = SHAPES[name]
    x = rng.uniform(-1, 1, (2, 70, cin))
    ws, bs = _mlp(rng, cin, hidden, cout)
    with jax.enable_x64(True):
        want = jsk._composed(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                             [jnp.asarray(b) for b in bs], 30.0, False)
    got = tsk.siren_mlp(*_port_args(x, ws, bs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("name", SHAPES)
@pytest.mark.parametrize("outermost_linear", [True, False])
def test_siren_module_matches_flax(rng, name, outermost_linear):
    """The Siren module, its last layer linear or a sine, on bridged flax
    weights, in float64: atol 1e-10."""
    cin, hidden, cout = SHAPES[name]
    n_hidden = len(hidden) - 1
    x = rng.uniform(-1, 1, (2, 50, cin))
    jm = JSiren(hidden, n_hidden, cout, outermost_linear=outermost_linear)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 2, cin)))["params"]
    params = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    with jax.enable_x64(True):
        want = jm.apply({"params": params}, jnp.asarray(x))
    tm = Siren(cin, hidden, n_hidden, cout, outermost_linear).double()
    tckpt.load_flax_params(tm, params)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)


def test_init_bounds():
    """First layer U(±1/in); hidden and outermost-linear U(±sqrt(6/in)/30)."""
    m = Siren(198, [64, 64, 64, 256], 3, 3)
    lins = m._linears()
    assert lins[0].weight.abs().max() <= first_bound(198)
    assert lins[0].weight.abs().max() > 0.9 * first_bound(198)
    for lin in lins[1:]:
        bound = hidden_bound(lin.in_features, 30.0)
        assert lin.weight.abs().max() <= bound
        assert lin.weight.abs().max() > 0.9 * bound
