"""The port's flow prior (models/flow.py) against the JAX package's, on the CPU.

Tiny flows (C = 8 flow channels, D = 6 conditioning, embedding 4, hidden 16),
weights built either way: numpy draws in net2net's state-dict names read by the
port and by JAX `convert_flow`; or the JAX init carried into the port by
`io.from_jax.flow_state_dict`. 1 and 3 flow blocks. Tolerance: float32,
2e-4 * max(1, max |JAX|) on z, logdet and reverse; the round trip
reverse(forward(x)) within 1e-4 of x.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feed_forward_vqgan_clip_tpu.io.torch_import import convert_flow
from feed_forward_vqgan_clip_tpu.models import flow as jflow
from feed_forward_vqgan_clip_tpu_torch.io.from_jax import flow_state_dict
from feed_forward_vqgan_clip_tpu_torch.models import flow

C, D, EMB, HIDDEN, HD = 8, 6, 4, 16, 1
MODEL = dict(embedding_dim=EMB, hidden_dim=HIDDEN, hidden_depth=HD)


def _tol(ref):
    return 2e-4 * max(1.0, float(np.abs(ref).max()))


def net2net_state_dict(n_flows, seed, *, buffers=True):
    """A net2net ConditionalFlatCouplingFlow state dict from numpy draws (weights
    N(0, 0.2^2), ActNorm scales |N| + 0.5), with the embedder's default widths
    (depth 2, hidden 256); `buffers=False` leaves out `initialized` and the
    backward shuffle index, as tests/test_flow.py's fake does."""
    rng = np.random.default_rng(seed)
    g = lambda *s: torch.from_numpy((0.2 * rng.normal(size=s)).astype(np.float32))  # noqa: E731

    def fc(prefix, din, hidden, dout, depth):
        d = {f"{prefix}.main.0.weight": g(hidden, din), f"{prefix}.main.0.bias": g(hidden)}
        for i in range(depth):
            d[f"{prefix}.main.{2 * (i + 1)}.weight"] = g(hidden, hidden)
            d[f"{prefix}.main.{2 * (i + 1)}.bias"] = g(hidden)
        d[f"{prefix}.main.{2 * (depth + 1)}.weight"] = g(dout, hidden)
        d[f"{prefix}.main.{2 * (depth + 1)}.bias"] = g(dout)
        return d

    sd = fc("embedder", D, 256, EMB, 2)
    for i in range(n_flows):
        p = f"sub_layers.{i}"
        sd[f"{p}.norm_layer.loc"] = g(1, C, 1, 1)
        sd[f"{p}.norm_layer.scale"] = g(1, C, 1, 1).abs() + 0.5
        perm = torch.from_numpy(rng.permutation(C))
        sd[f"{p}.shuffle.forward_shuffle_idx"] = perm
        if buffers:
            sd[f"{p}.norm_layer.initialized"] = torch.tensor(1, dtype=torch.uint8)
            sd[f"{p}.shuffle.backward_shuffle_idx"] = torch.argsort(perm)
        for j in range(2):
            sd.update(fc(f"{p}.coupling.s.{j}", C // 2 + EMB, HIDDEN, C // 2, HD))
            sd.update(fc(f"{p}.coupling.t.{j}", C // 2 + EMB, HIDDEN, C // 2, HD))
    return sd


def random_prior(c, d, n_flows, seed, model=None):
    """A port flow (C = c, D = d) whose every float entry is a numpy draw:
    matrices and biases N(0, 0.2^2), ActNorm locs N(0, 0.2^2) and scales
    |N(0, 0.2^2)| + 0.5; -> (flow, config)."""
    cfg = {"model": dict(model or MODEL, n_flows=n_flows)}
    port = flow.build_prior_model(cfg, d, c, device="cpu")
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in port.state_dict().items():
        if v.is_floating_point():
            a = 0.2 * rng.normal(size=v.shape)
            v = torch.from_numpy((np.abs(a) + 0.5 if k.endswith("scale") else a).astype(
                np.float32))
        sd[k] = v
    port.load_state_dict(sd)
    return port, cfg


def _flows(n_flows):
    port = flow.build_prior_model({"model": dict(MODEL, n_flows=n_flows)}, D, C, device="cpu")
    jax_flow = jflow.build_prior_model({"model": dict(MODEL, n_flows=n_flows)}, D, C)
    return port, jax_flow


def _inputs(seed, b=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, C)).astype(np.float32),
            rng.normal(size=(b, D)).astype(np.float32))


def _check_same(port, jax_flow, variables, seed):
    x, cond = _inputs(seed)
    jz, jld = jax_flow.apply(variables, jnp.asarray(x), jnp.asarray(cond))
    jrev = jax_flow.apply(variables, jnp.asarray(x), jnp.asarray(cond), method=jax_flow.reverse)
    with torch.no_grad():
        z, ld = port(torch.from_numpy(x), torch.from_numpy(cond))
        rev = port.reverse(torch.from_numpy(x), torch.from_numpy(cond))
    for got, want in ((z, jz), (ld, jld), (rev, jrev)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert float(np.abs(got.numpy() - want).max()) <= _tol(want)


@pytest.mark.parametrize("n_flows", [1, 3])
def test_port_weights_through_convert_flow_match_jax(n_flows):
    """net2net-named weights loaded by the port and converted by `convert_flow`:
    forward (z, logdet) and reverse agree."""
    port, jax_flow = _flows(n_flows)
    sd = net2net_state_dict(n_flows, seed=n_flows)
    port.load_state_dict(sd)
    variables = convert_flow({k: v.numpy() for k, v in sd.items()}, n_flows=n_flows)
    _check_same(port, jax_flow, variables, seed=10 + n_flows)
    assert sorted(port.state_dict()) == sorted(sd)


@pytest.mark.parametrize("n_flows", [1, 3])
def test_jax_init_through_flow_state_dict_matches_jax(n_flows):
    """The JAX init (its RandomState permutations, ActNorm at 1/0) carried by
    `flow_state_dict`; the port's fresh permutations equal the JAX buffers."""
    port, jax_flow = _flows(n_flows)
    variables = jax_flow.init(jax.random.PRNGKey(n_flows), jnp.zeros((1, C)), jnp.zeros((1, D)))
    fresh = {k: v.clone() for k, v in port.state_dict().items() if "shuffle" in k}
    sd = flow_state_dict(jax.tree.map(np.asarray, variables))
    for k, v in fresh.items():
        assert torch.equal(v, sd[k]), k
    port.load_state_dict(sd)
    _check_same(port, jax_flow, variables, seed=20 + n_flows)


@pytest.mark.parametrize("n_flows", [1, 3])
def test_reverse_inverts_forward(n_flows):
    port, _ = _flows(n_flows)
    port.load_state_dict(net2net_state_dict(n_flows, seed=30 + n_flows))
    x, cond = _inputs(31)
    with torch.no_grad():
        z, _ = port(torch.from_numpy(x), torch.from_numpy(cond))
        back = port.reverse(z, torch.from_numpy(cond))
    assert float((back - torch.from_numpy(x)).abs().max()) <= 1e-4


def test_logdet_matches_the_jacobian():
    port, _ = _flows(2)
    port.load_state_dict(net2net_state_dict(2, seed=40))
    x, cond = (torch.from_numpy(a[:1]) for a in _inputs(41))
    _, logdet = port(x, cond)
    jac = torch.autograd.functional.jacobian(lambda v: port(v[None], cond)[0][0], x[0])
    want = float(torch.linalg.slogdet(jac.double())[1])
    assert abs(logdet[0].item() - want) <= 1e-4 * max(1.0, abs(want))


def test_nll_loss_matches_jax():
    rng = np.random.default_rng(50)
    z, ld = rng.normal(size=(7, C)).astype(np.float32), rng.normal(size=7).astype(np.float32)
    loss, aux = flow.nll_loss(torch.from_numpy(z), torch.from_numpy(ld))
    jloss, jaux = jflow.nll_loss(jnp.asarray(z), jnp.asarray(ld))
    assert abs(float(loss) - float(jloss)) <= 1e-6 * max(1.0, abs(float(jloss)))
    for k in ("nll_loss", "nlogdet_loss"):
        assert abs(float(aux[k]) - float(jaux[k])) <= 1e-6 * max(1.0, abs(float(jaux[k])))


def test_load_prior_model_reads_a_reference_file_without_the_optional_buffers(tmp_path):
    """A {model, step, input_size, output_size, config} `.th` whose state dict lacks
    `initialized` and the backward index loads; its samples for a pinned z
    equal JAX load_prior_model's reverse of the same file."""
    sd = net2net_state_dict(2, seed=60, buffers=False)
    path = str(tmp_path / "prior.th")
    torch.save({"model": sd, "step": 3, "input_size": D, "output_size": C,
                "config": {"model": dict(MODEL, n_flows=2)}}, path)
    prior = flow.load_prior_model(path, device="cpu")
    assert not any(p.requires_grad for p in prior.flow.parameters())
    jprior = jflow.load_prior_model(path)
    z, cond = _inputs(61)
    want = np.asarray(jprior.flow.apply(jprior.variables, jnp.asarray(z), jnp.asarray(cond),
                                        method=jprior.flow.reverse))
    got = prior.reverse(torch.from_numpy(z), torch.from_numpy(cond)).numpy()
    assert float(np.abs(got - want).max()) <= _tol(want)


def test_sample_draws_from_the_generator():
    port, _ = _flows(2)
    port.init_random_(torch.Generator().manual_seed(0))
    prior = flow.Prior(port)
    cond = torch.from_numpy(_inputs(70)[1])
    a = prior.sample(cond, torch.Generator().manual_seed(1))
    b = prior.sample(cond, torch.Generator().manual_seed(1))
    c = prior.sample(cond, torch.Generator().manual_seed(2))
    assert a.shape == (5, C) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    z = prior.noise(5, torch.Generator().manual_seed(1))
    assert torch.equal(a, prior.reverse(z, cond))


def test_save_prior_round_trips_and_dirs_raise(tmp_path):
    port, _ = _flows(3)
    port.init_random_(torch.Generator().manual_seed(4))
    cfg = {"model": dict(MODEL, n_flows=3), "seed": 0}
    path = flow.save_prior(str(tmp_path / "p.th"), port, cfg, step=9)
    obj = torch.load(path, weights_only=False)
    assert (obj["step"], obj["input_size"], obj["output_size"]) == (9, D, C)
    loaded = flow.load_prior_model(path, device="cpu").flow
    for k, v in port.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    with pytest.raises(FileNotFoundError):  # a directory is a JAX prior: meta.json needed
        flow.load_prior_model(str(tmp_path), device="cpu")
