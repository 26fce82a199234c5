"""Shared set-up of the port's parity tests: the same model built by
``nf_tpu`` (JAX, CPU) and by ``nf_tpu_torch`` (PyTorch, CPU), with the JAX
variables carried across, and inputs made with numpy."""
from __future__ import annotations

import jax
import numpy as np
import torch

torch.set_num_threads(1)


def to_numpy(var):
    return jax.tree.map(np.asarray, var)


def normal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def jax_model(name: str, D: int, layers: int, filters: int, seed: int = 0,
              batch: int = 64, mixtures: int = 4, logdet: str = "unbias",
              spnorm_coeff: float = 0.9):
    """An nf_tpu density model after its data-dependent init (ActNorm; for
    ResFlow also one spectral-norm power iteration) and with any
    batch-norm running statistics moved off their init values (as
    tests/test_pallas.py does), so the folding of those statistics has
    teeth.  Returns (model, numpy var)."""
    from nf_tpu.config import NetworkConfig
    from nf_tpu.core import Ctx
    from nf_tpu.models import build_model

    cfg = NetworkConfig(name=name, layers=layers, base_filters=filters,
                        mixtures=mixtures, logdet=logdet, spnorm_coeff=spnorm_coeff)
    model = build_model(name, (D,), datatype="2d", cfg=cfg)
    rng = jax.random.PRNGKey(seed)
    var = model.init(rng)
    x = normal(seed + 100, (batch, D))
    var = model.data_dependent_init(var, x * 1.5 + 0.3)
    if name in ("realnvp", "glow"):
        ctx_t = Ctx(rng=jax.random.fold_in(rng, 2), train=True)
        fwd = jax.jit(lambda v, y: model.bijector.forward(v, y, ctx_t)[2])
        for _ in range(3):
            var = {"params": var["params"], "state": fwd(var, x * 1.3)}
    return model, to_numpy(var)


def torch_model(name: str, D: int, layers: int, filters: int, var=None,
                mixtures: int = 4, logdet: str = "unbias", spnorm_coeff: float = 0.9):
    """The port's density model on the CPU, with ``var`` (an nf_tpu
    variables pytree of numpy arrays) loaded when given."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model

    cfg = NetworkConfig(name=name, layers=layers, base_filters=filters,
                        mixtures=mixtures, logdet=logdet, spnorm_coeff=spnorm_coeff)
    model = build_model(name, (D,), "2d", cfg, device="cpu")
    if var is not None:
        load_jax_variables(model, var)
    return model


def uniform(seed: int, shape, low: float = 0.05, high: float = 0.95) -> np.ndarray:
    """Pixels away from the Logit edges, as bench.py makes its batches."""
    return np.random.default_rng(seed).uniform(low, high, shape).astype(np.float32)


def jax_image_model(dims=(16, 16, 1), layers: int = 1, filters: int = 8, seed: int = 0,
                    batch: int = 16, train_passes: int = 3):
    """nf_tpu's image RealNVP after its data-dependent init and
    ``train_passes`` train-mode passes, which move every batch-norm
    running statistic off its init value.  Returns (model, numpy var)."""
    from nf_tpu.config import NetworkConfig
    from nf_tpu.core import Ctx
    from nf_tpu.models import build_model

    cfg = NetworkConfig(name="realnvp", layers=layers, base_filters=filters)
    model = build_model("realnvp", dims, datatype="image", cfg=cfg)
    var = model.init(jax.random.PRNGKey(seed))
    x = uniform(seed + 100, (batch,) + tuple(dims))
    var = model.data_dependent_init(var, x)
    ctx_t = Ctx(rng=None, train=True)
    fwd = jax.jit(lambda v, y: model.bijector.forward(v, y, ctx_t)[2])
    for i in range(train_passes):
        var = {"params": var["params"], "state": fwd(var, uniform(seed + 101 + i, x.shape))}
    return model, to_numpy(var)


def torch_image_model(dims=(16, 16, 1), layers: int = 1, filters: int = 8, var=None):
    """The port's image RealNVP on the CPU, with ``var`` loaded when given."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model

    cfg = NetworkConfig(name="realnvp", layers=layers, base_filters=filters)
    model = build_model("realnvp", dims, "image", cfg, device="cpu")
    if var is not None:
        load_jax_variables(model, var)
    return model


def jax_realnvp(D: int, layers: int, filters: int, seed: int = 0, batch: int = 64):
    return jax_model("realnvp", D, layers, filters, seed, batch)


def torch_realnvp(D: int, layers: int, filters: int, var=None):
    return torch_model("realnvp", D, layers, filters, var)


def nf_unbias_probes(B: int, D: int):
    """nf_tpu's serving 'unbias' draws (PRNGKey(0), the key every eval block
    uses) in the port's layout: (V (S, B, D), n_terms (S,) int32)."""
    from nf_tpu.ops.pallas.fused_resflow import draw_unbias_probes

    V, thr, _ = draw_unbias_probes(B, D)
    return (torch.from_numpy(np.asarray(V).transpose(1, 2, 0).copy()),
            torch.from_numpy(np.asarray(thr)[0, :, 0].astype(np.int32)))


def nf_fixed_probes(B: int, D: int):
    """nf_tpu's serving 'fixed' draws from PRNGKey(0), port layout."""
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, (B, D)))
                                      for k in keys])), None


def as_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(as_numpy(a), as_numpy(b), atol=atol, rtol=rtol)


# ------------------------------------------------------------ ResFlow training
def nf_train_draws(key, shape):
    """nf_tpu's training draws of one residual block from its key
    (``iresblock_forward``): ``k_val, k_grad = split(key)``, the value pair
    from ``split(k_val, 1)[0]``, the Neumann pair from ``k_grad``, each
    ``(kn, kv) -> (1 + geometric(kn), normal(kv, shape))``; in the port's
    ``((n_val, v_val), (n_grad, v_grad))``."""
    from nf_tpu.ops.estimators import geometric

    k_val, k_grad = jax.random.split(key)
    out = []
    for k in (jax.random.split(k_val, 1)[0], k_grad):
        kn, kv = jax.random.split(k)
        out.append((1 + int(geometric(kn, 0.5)),
                    torch.from_numpy(np.array(jax.random.normal(kv, tuple(shape))))))
    return tuple(out)


def nf_eval_draws(shape):
    """nf_tpu's serving 'unbias' draws (PRNGKey(0)) of the data's shape:
    (V (4, *shape), n_terms (4,) int32)."""
    from nf_tpu.ops.estimators import geometric

    vs, ns = [], []
    for k in jax.random.split(jax.random.PRNGKey(0), 4):
        kn, kv = jax.random.split(k)
        ns.append(8 + int(geometric(kn, 0.5)))
        vs.append(np.asarray(jax.random.normal(kv, tuple(shape))))
    return torch.from_numpy(np.stack(vs)), torch.tensor(ns, dtype=torch.int32)


def resflow_block_pair(conv: bool, coeff: float, seed: int = 3):
    """nf_tpu's residual block (dense g on (7, 3), or conv g on 4x4x2 with
    the operator spectral norm) and the port's with its variables, the
    LipSwish betas off 1.  Returns (nf_tpu block, numpy var, port block,
    input shape)."""
    from nf_tpu.bijectors.iresblock import InvertibleResConv2d as JRC
    from nf_tpu.bijectors.iresblock import InvertibleResLinear as JRL
    from nf_tpu_torch.bijectors.iresblock import InvertibleResConv2d, InvertibleResLinear
    from nf_tpu_torch.convert import load_jax_variables

    if conv:
        shape = (5, 4, 4, 2)
        kw = dict(base_filters=8, coeff=coeff, spatial=(4, 4))
        jb, tb = JRC(2, 2, **kw), InvertibleResConv2d(2, 2, device="cpu", **kw)
    else:
        shape = (7, 3)
        jb = JRL(3, 3, base_filters=8, coeff=coeff)
        tb = InvertibleResLinear(3, 3, base_filters=8, coeff=coeff, device="cpu")
    var = to_numpy(jb.init(jax.random.PRNGKey(seed)))
    var["params"]["g"][1]["beta"] = np.float32([0.8])
    var["params"]["g"][3]["beta"] = np.float32([1.3])
    load_jax_variables(tb, var)
    return jb, var, tb, shape


def jax_resflow(dims, datatype, layers, filters, seed=0, **cfg_kw):
    """nf_tpu's ResFlow (``allow_image`` for image data) and its init var."""
    from nf_tpu.config import NetworkConfig
    from nf_tpu.models import build_model

    cfg = NetworkConfig(name="resflow", layers=layers, base_filters=filters,
                        allow_image=datatype == "image", **cfg_kw)
    model = build_model("resflow", dims, datatype=datatype, cfg=cfg)
    return model, model.init(jax.random.PRNGKey(seed))


def torch_resflow(dims, datatype, layers, filters, var=None, **cfg_kw):
    """The port's ResFlow on the CPU, with ``var`` loaded when given."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model

    cfg = NetworkConfig(name="resflow", layers=layers, base_filters=filters,
                        allow_image=datatype == "image", **cfg_kw)
    model = build_model("resflow", dims, datatype, cfg, device="cpu")
    if var is not None:
        load_jax_variables(model, to_numpy(var))
    return model


def resflow_trainer_parity(dims, datatype, layers, filters, batches, logp_atol, port_kw=None,
                           **cfg_kw):
    """Three Trainer steps of the port's ResFlow against nf_tpu's, every
    block handed nf_tpu's draws (the data-dependent init's key
    ``fold_in(PRNGKey(0), 1)``, each step's ``fold_in(PRNGKey(0), step)``,
    folded along the block's key path, ``nf_layer_keys``; ``cfg_kw`` such
    as ``scan`` / ``remat`` goes to both configs, ``port_kw`` to the port's
    alone): the first step's gradients
    within 1e-5 + 1e-5 relative, the losses within rtol 1e-5, every
    parameter and u / v within 1e-5 after the steps, and u, v and the
    LipSwish betas moved by them; then the trained state served by both
    EvalPrograms on ``batches[0]`` with nf_tpu's serving draws: log p
    within ``logp_atol``, the inverse within 1e-4.  Returns the port's
    program."""
    from nf_tpu.config import OptimizerConfig as JOptimizerConfig
    from nf_tpu.core import Ctx
    from nf_tpu.train import Trainer as JTrainer
    from nf_tpu_torch.bijectors.iresblock import InvertibleResBlock
    from nf_tpu_torch.config import OptimizerConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.train import Trainer

    jm, var0 = jax_resflow(dims, datatype, layers, filters, **cfg_kw)
    key = jax.random.PRNGKey(0)
    jt = JTrainer(jm, JOptimizerConfig(), seed=0)
    jts = jt.init_state(key, batches[0])

    def loss(params, batch, rng):
        v = {"params": params, "state": jts.state}
        return -jm.log_prob(v, batch, Ctx(rng=rng, train=True))[0].mean()

    jgrads = jax.grad(loss)(jts.params, batches[1], jax.random.fold_in(key, 0))
    jlosses = []
    for k in range(1, 4):
        jts, lj = jt.train_step(jts, batches[k])
        jlosses.append(float(lj))

    # ``twin`` has nf_tpu's structure; the port's model (``port_kw`` may
    # scan it) takes the twin's state and nf_tpu's keys in module order
    twin = torch_resflow(dims, datatype, layers, filters, **cfg_kw)
    tm = torch_resflow(dims, datatype, layers, filters, **cfg_kw, **(port_kw or {}))
    blocks = [m for m in tm.modules() if isinstance(m, InvertibleResBlock)]

    def inject(key):
        keys = [k for m, k in nf_layer_keys(twin.bijector, key)
                if isinstance(m, InvertibleResBlock)]
        for m, k in zip(blocks, keys, strict=True):
            m.injected_train_probes = nf_train_draws(k, inner)

    inner = (batches.shape[1],) + ((dims[0] // 2, dims[1] // 2, 4 * dims[2])
                                   if datatype == "image" else tuple(dims))
    tt = Trainer(tm, OptimizerConfig(), seed=0)
    inject(jax.random.fold_in(key, 1))
    load_jax_variables(twin, to_numpy(var0))
    ts = tt.init_state(torch.from_numpy(batches[0]),
                       params=dict(zip(tm.state_dict(), twin.state_dict().values())))
    start = [v.clone() for v in tm.state_dict().values()]
    losses = []
    for k in range(1, 4):
        inject(jax.random.fold_in(key, ts.step))
        ts, lt = tt.train_step(ts, torch.from_numpy(batches[k]))
        losses.append(float(lt))
        if k == 1:
            want = torch_resflow(dims, datatype, layers, filters,
                                 {"params": jgrads, "state": jts.state}, **cfg_kw)
            for p, w in zip(tm.parameters(), want.parameters(), strict=True):
                close(p.grad, w.detach(), 1e-5, 1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    ref = torch_resflow(dims, datatype, layers, filters, jts.var, **cfg_kw).state_dict()
    for (name, want), got, was in zip(ref.items(), tm.state_dict().values(), start,
                                      strict=True):
        close(got.float(), want.float(), 1e-5)
        if name.endswith((".u", ".v", ".beta")):
            assert not torch.equal(got, was), name

    prog = tm.eval_program(probes=nf_eval_draws(inner))
    jprog = jm.eval_program(jts.var)
    x = batches[0]
    close(prog.log_prob(torch.from_numpy(x)), jprog.log_prob(x), logp_atol)
    jz, _ = jprog.forward(x)
    close(prog.inverse(torch.from_numpy(np.array(jz)))[0], jprog.inverse(jz)[0], 1e-4)
    return prog


# ------------------------------------------------------- scan / remat / flags
def nf_layer_keys(bij, key):
    """(layer, nf_tpu's PRNG key of that layer) for every layer under the
    port's ``bij``, on nf_tpu's key path: a ``Chain`` folds in the layer's
    index (``Ctx.child``), a ``ScannedChain`` the block's, then the block's
    ``Chain`` the layer's index inside the block."""
    from nf_tpu_torch.core.bijector import Chain, ScannedChain

    if isinstance(bij, Chain):
        subs = bij.layers
    elif isinstance(bij, ScannedChain):
        subs = bij.blocks
    else:
        yield bij, key
        return
    for i, m in enumerate(subs):
        yield from nf_layer_keys(m, jax.random.fold_in(key, i))


def bijector_structure(bij):
    """Class names and remat flags of a bijector tree, for either package
    (``Chain.layers``, ``ScannedChain.blocks``)."""
    name = type(bij).__name__
    if name in ("Chain", "ScannedChain"):
        subs = bij.layers if name == "Chain" else bij.blocks
        return name, bool(bij.remat), tuple(bijector_structure(m) for m in subs)
    return name


def assert_trees_equal(a, b, path=""):
    """Two numpy pytrees of one structure, leaf for leaf: same shape,
    dtype and values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def flag_parity(name, dims, datatype, atol=1e-4, logp=True, seed=0, batch=8, eager=False,
                **cfg_kw):
    """nf_tpu's model and the port's built with the same config (``scan``,
    ``remat``, ``compute_dtype``, ...): the same bijector structure, nf_tpu's
    init variables loaded and exported back unchanged, and (``logp``) the
    serving log p of ``batch`` samples within ``atol``, nf_tpu's program
    run op by op with ``eager`` (``jax.disable_jit``: under jit XLA's CPU
    keeps bf16 intermediates in f32, so a bf16 model is held to nf_tpu's
    own bf16 roundings op by op).  Returns (nf_tpu model, numpy var, port
    model)."""
    from nf_tpu.config import NetworkConfig as JNC
    from nf_tpu.models import build_model as jbuild
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import export_jax_variables, load_jax_variables
    from nf_tpu_torch.models import build_model

    jm = jbuild(name, dims, datatype=datatype, cfg=JNC(name=name, **cfg_kw))
    tm = build_model(name, dims, datatype, NetworkConfig(name=name, **cfg_kw), device="cpu")
    assert bijector_structure(tm.bijector) == bijector_structure(jm.bijector)
    var = to_numpy(jm.init(jax.random.PRNGKey(seed)))
    load_jax_variables(tm, var)
    assert_trees_equal(export_jax_variables(tm), var)
    if logp:
        x = (uniform(seed + 7, (batch,) + tuple(dims)) if datatype == "image"
             else normal(seed + 7, (batch,) + tuple(dims)))
        with jax.disable_jit(eager):
            want = np.asarray(jm.eval_program(var).log_prob(x))
        close(tm.eval_program().log_prob(torch.from_numpy(x)), want, atol, 1e-6)
    return jm, var, tm


# ------------------------------------------------------------ Trainer parity
def _grads_in_port_layout(tmodel_factory, grads, state):
    """nf_tpu's gradient pytree loaded into a fresh port model, whose
    parameters then hold the gradients in the port's layouts."""
    from nf_tpu_torch.convert import load_jax_variables

    m = tmodel_factory()
    load_jax_variables(m, to_numpy({"params": grads, "state": state}))
    return dict(m.named_parameters())


NOISE_DRIVEN = 1e-3      # 2 x 3 steps x lr (1e-4), with a margin
MEANS = 2e-3             # a few noise-driven shifts added up


def _f64_grads(make_model, state, batch):
    """The first step's gradients of the same state in float64."""
    m = make_model()
    m.load_state_dict(state)
    m = m.double().train()
    (-m.log_prob(torch.from_numpy(batch).double()).mean()).backward()
    return {n: p.grad for n, p in m.named_parameters()}


def trainer_parity(dims, datatype, layers, filters, batches, name="realnvp",
                   f64_arbiter=False, inject=None, **cfg_kw):
    """Three Adam steps of the same model in both packages on the same
    batches, after the same init and data-dependent init (the rules in
    ``tests/test_torch_train.py``'s docstring).  ``cfg_kw`` goes to both
    configs (``scan``, ``remat``, ...); nf_tpu's gradients are taken with
    its first step's key, and ``inject(model, key)``, when given, hands the
    port's model nf_tpu's draws for a key before the data-dependent init
    (``fold_in(PRNGKey(0), 1)``) and before each step
    (``fold_in(PRNGKey(0), step)``).  Returns the port's model."""
    from nf_tpu.config import NetworkConfig as JNetworkConfig
    from nf_tpu.config import OptimizerConfig as JOptimizerConfig
    from nf_tpu.core import Ctx
    from nf_tpu.models import build_model as jbuild
    from nf_tpu.train import Trainer as JTrainer
    from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.train import Trainer

    kw = dict(name=name, layers=layers, base_filters=filters, mixtures=2, **cfg_kw)

    def tmodel():
        return build_model(name, dims, datatype, NetworkConfig(**kw), device="cpu")

    jmodel = jbuild(name, dims, datatype=datatype, cfg=JNetworkConfig(**kw))
    key = jax.random.PRNGKey(0)
    var0 = jmodel.init(key)
    jt = JTrainer(jmodel, JOptimizerConfig(), seed=0)
    jts = jt.init_state(key, batches[0])

    def loss(params, batch):
        v = {"params": params, "state": jts.state}
        ctx = Ctx(rng=jax.random.fold_in(jt.base_key, 0), train=True)
        return -jmodel.log_prob(v, batch, ctx)[0].mean()

    jgrads = jax.grad(loss)(jts.params, batches[1])
    jlosses = []
    for k in range(1, 4):
        jts, lj = jt.train_step(jts, batches[k])
        jlosses.append(float(lj))

    model = tmodel()
    tt = Trainer(model, OptimizerConfig(), seed=0)
    params = load_jax_variables(model, to_numpy(var0))
    if inject is not None:
        inject(model, jax.random.fold_in(key, 1))
    ts = tt.init_state(torch.from_numpy(batches[0]), params=params)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    losses = []
    for k in range(1, 4):
        if inject is not None:
            inject(model, jax.random.fold_in(jt.base_key, ts.step))
        ts, lt = tt.train_step(ts, torch.from_numpy(batches[k]))
        losses.append(float(lt))
        if k == 1:
            first = _grads_in_port_layout(tmodel, jgrads, jts.state)
            g64 = {}
            for pname, p in model.named_parameters():
                want = first[pname].detach()
                off = (p.grad - want).abs() > 1e-5 + 1e-5 * want.abs()
                if not (f64_arbiter and off.any()):
                    close(p.grad, want, 1e-5, 1e-5)
                    continue
                # an entry past 1e-5 of nf_tpu's: held to the same 1e-5 of the
                # float64 gradient, or to nf_tpu's own f32 distance from it
                g64 = g64 or _f64_grads(tmodel, start, batches[1])
                ref = g64[pname]
                err = (p.grad.double() - ref).abs()
                bound = torch.maximum((want.double() - ref).abs(), 1e-5 + 1e-5 * ref.abs())
                assert (err <= bound)[off].all(), pname
    assert ts.step == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)

    ref = tmodel()
    load_jax_variables(ref, to_numpy(jts.var))
    want = ref.state_dict()
    params = dict(model.named_parameters())
    for key, got in model.state_dict().items():
        diff = (got.float() - want[key].float()).abs()
        if key in params:
            real = first[key].detach().abs() > 1e-4
            assert not real.any() or diff[real].max() <= 1e-5, key
            assert diff.max() <= NOISE_DRIVEN, key
        elif key.endswith("_var"):
            assert diff.max() <= 1e-5, key
        elif key.endswith("_mean"):
            assert diff.max() <= MEANS, key
        else:
            assert diff.max() == 0, key
    return model
