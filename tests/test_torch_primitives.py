"""The NN primitives no shipped configuration uses, and the denseNorm
blocks, against the JAX package's flax modules, fp64 (`mcquic_tpu/nn/convs.py`,
`mcquic_tpu/nn/blocks.py`): `conv5x5`; `PixelShuffleConv` through
`pixelShuffle5x5` / `pixelShuffle1x1` / `pixelShuffle3x3` at rate 2, 1 and
0.5, with and without groups; `MaskedConv` of types A and B;
`ResidualBlockMasked`; `NonLocalBlock` in eval mode and in training mode,
where it is handed the JAX package's own uniforms; `ResidualBlock` and
`AttentionBlock` with `denseNorm` (the GroupNorm at `_branch.2`).

Every flax leaf is a numpy-seeded value (shapes from `jax.eval_shape` of the
flax init) carried into the port by the name table of each case; the same
NHWC input goes through both.

Tolerances. Convolutions, shuffles and masks agree to fp64 rounding: ATOL
1e-12 at unit scale. The GroupNorm: flax computes the variance as E[x^2] -
E[x]^2 and torch as the mean squared deviation, also fp64 rounding, ATOL
1e-12. The NonLocalBlock rounds its logits and softmax to fp32 in both
packages (`preferred_element_type=jnp.float32`), so it is held to 16 fp32
ulps at unit scale (FP32_ROUNDED), as the generator's parity tests are.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu import nn as jnn
from mcquic_tpu_torch import nn as tnn

F64 = jnp.float64
ATOL = 1e-12
FP32_ROUNDED = 16 * 2 ** -23


def seededLeaf(path, shape, rng):
    name = path[-1]
    if name == "kernel":
        return rng.uniform(-1, 1, shape) / np.sqrt(int(np.prod(shape[:-1])))
    if name == "scale":
        return 1 + rng.uniform(-0.2, 0.2, shape)
    if name == "bias":
        return rng.uniform(-0.1, 0.1, shape)
    raise KeyError(path)


def seededParams(module, x, rng):
    shapes = jax.eval_shape(lambda: module.init({"params": jax.random.PRNGKey(0)}, x))
    leaves = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    flat = {tuple(p.key for p in path): seededLeaf(tuple(p.key for p in path), leaf.shape, rng)
            for path, leaf in leaves}
    tree = {}
    for path, value in flat.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value
    return flat, {"params": tree}


def portState(flat, table):
    """flax leaves -> the port's state dict through `table`: port prefix ->
    (flax prefix, kind); kind `conv` (HWIO kernel, optional bias) or `norm`."""
    state = {}
    for portPrefix, (flaxPrefix, kind) in table.items():
        dot = f"{portPrefix}." if portPrefix else ""
        if kind == "conv":
            state[f"{dot}weight"] = flat[(*flaxPrefix, "kernel")].transpose(3, 2, 0, 1)
            if (*flaxPrefix, "bias") in flat:
                state[f"{dot}bias"] = flat[(*flaxPrefix, "bias")]
        else:
            state[f"{dot}weight"] = flat[(*flaxPrefix, "scale")]
            state[f"{dot}bias"] = flat[(*flaxPrefix, "bias")]
    used = {(*f, leaf) for f, kind in table.values()
            for leaf in (("kernel", "bias") if kind == "conv" else ("scale", "bias"))}
    assert set(flat) <= used, sorted(set(flat) - used)
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def residualTable(prefix, flax, skip, denseNorm=True):
    table = {f"{prefix}_branch.1": ((*flax, "Conv_0", "Conv_0"), "conv"),
             f"{prefix}_branch.3": ((*flax, "Conv_1", "Conv_0"), "conv")}
    if denseNorm:
        table[f"{prefix}_branch.2"] = ((*flax, "GroupNorm_0"), "norm")
    if skip:
        table[f"{prefix}_skip"] = ((*flax, "Conv_2", "Conv_0"), "conv")
    return table


def attentionTable():
    table = {}
    for j in range(3):
        table.update(residualTable(f"_mainBranch.{j}.", (f"ResidualBlock_{j}",), False))
        table.update(residualTable(f"_sideBranch.{j}.", (f"ResidualBlock_{3 + j}",), False))
    table["_sideBranch.3"] = (("Conv_0", "Conv_0"), "conv")
    return table


def shuffleCase(kernel, rate, groups, cIn=8, features=8):
    jaxFn = {1: jnn.pixelShuffle1x1, 3: jnn.pixelShuffle3x3, 5: jnn.pixelShuffle5x5}[kernel]
    portFn = {1: tnn.pixelShuffle1x1, 3: tnn.pixelShuffle3x3, 5: tnn.pixelShuffle5x5}[kernel]
    return (f"pixelShuffle{kernel}x{kernel} rate {rate} groups {groups}",
            lambda: jaxFn(features, rate=rate, groups=groups, dtype=F64),
            lambda: portFn(cIn, features, rate, groups), {"0": (("Conv_0",), "conv")},
            (2, 6, 8, cIn), ATOL)


CASES = [
    ("conv5x5", lambda: jnn.conv5x5(6, dtype=F64), lambda: tnn.conv5x5(4, 6),
     {"": (("Conv_0",), "conv")}, (2, 7, 9, 4), ATOL),
    ("conv5x5 stride 2 groups 2", lambda: jnn.conv5x5(6, stride=2, groups=2, dtype=F64),
     lambda: tnn.conv5x5(4, 6, 2, groups=2), {"": (("Conv_0",), "conv")}, (2, 7, 9, 4), ATOL),
    shuffleCase(5, 2, 1), shuffleCase(1, 2, 1), shuffleCase(1, 0.5, 1), shuffleCase(5, 0.5, 1),
    shuffleCase(3, 0.5, 2), shuffleCase(5, 2, 2), shuffleCase(3, 1, 2), shuffleCase(1, 1, 1),
    ("MaskedConv A", lambda: jnn.MaskedConv(6, kernel=5, maskType="A", dtype=F64),
     lambda: tnn.MaskedConv(4, 6, 5, "A"), {"": ((), "conv")}, (2, 7, 9, 4), ATOL),
    ("MaskedConv B with bias", lambda: jnn.MaskedConv(6, kernel=3, maskType="B", useBias=True,
                                                       dtype=F64),
     lambda: tnn.MaskedConv(4, 6, 3, "B", bias=True), {"": ((), "conv")}, (2, 7, 9, 4), ATOL),
    ("ResidualBlockMasked A, width 4 -> 6", lambda: jnn.ResidualBlockMasked(6, "A", dtype=F64),
     lambda: tnn.ResidualBlockMasked(4, 6, "A"),
     {"_branch.1": (("MaskedConv_0",), "conv"), "_branch.3": (("MaskedConv_1",), "conv"),
      "_skip": (("MaskedConv_2",), "conv")}, (2, 7, 9, 4), ATOL),
    ("ResidualBlockMasked B, width 6", lambda: jnn.ResidualBlockMasked(6, "B", dtype=F64),
     lambda: tnn.ResidualBlockMasked(6, 6, "B"),
     {"_branch.1": (("MaskedConv_0",), "conv"), "_branch.3": (("MaskedConv_1",), "conv")},
     (2, 7, 9, 6), ATOL),
    ("NonLocalBlock eval, groups 2", lambda: jnn.NonLocalBlock(groups=2, dtype=F64),
     lambda: tnn.NonLocalBlock(8, groups=2),
     {name: ((f"Conv_{i}", "Conv_0"), "conv") for i, name in enumerate(("_q", "_k", "_v", "_z"))},
     (2, 5, 6, 8), FP32_ROUNDED),
    ("ResidualBlock denseNorm, 1 group, width 8 -> 12",
     lambda: jnn.ResidualBlock(12, 1, True, dtype=F64), lambda: tnn.ResidualBlock(8, 12, 1, True),
     residualTable("", (), True), (2, 6, 5, 8), ATOL),
    ("ResidualBlock denseNorm, 4 groups", lambda: jnn.ResidualBlock(8, 4, True, dtype=F64),
     lambda: tnn.ResidualBlock(8, 8, 4, True), residualTable("", (), False), (2, 6, 5, 8), ATOL),
    ("AttentionBlock denseNorm, 4 groups", lambda: jnn.AttentionBlock(4, True, dtype=F64),
     lambda: tnn.AttentionBlock(8, 4, True), attentionTable(), (2, 6, 5, 8), ATOL),
]


def runCase(jaxModule, portModule, table, shape, seed=0, rngs=None, train=False, draw=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    with jax.enable_x64():
        flat, variables = seededParams(jaxModule, jnp.asarray(x), rng)
        kwargs = {"train": True} if train else {}
        want = np.asarray(jaxModule.apply(variables, jnp.asarray(x), rngs=rngs, **kwargs))
    portModule = portModule.double()
    portModule.load_state_dict(portState(flat, table), strict=True)
    portModule.train(train)
    with torch.no_grad():
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
        got = (portModule(xt, draw=draw) if draw else portModule(xt)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == want.shape
    return want, got


@pytest.mark.parametrize("name,jaxMake,portMake,table,shape,atol", CASES,
                         ids=[c[0] for c in CASES])
def test_primitive_matches_flax(name, jaxMake, portMake, table, shape, atol):
    want, got = runCase(jaxMake(), portMake(), table, shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_non_local_block_in_training_masks_with_the_jax_uniforms(monkeypatch):
    """The JAX block draws its [n, hw, hw] mask uniforms from the `dropout`
    stream; they are recorded (jax.random.uniform wrapped, un-jitted) and
    handed to the port's `draw`. At maskRate 0.5 about half the logits are
    masked, so the check cannot pass on an unmasked softmax."""
    recorded, uniform = [], jax.random.uniform

    def record(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        value = uniform(key, shape, dtype, minval, maxval)
        recorded.append(np.asarray(value))
        return value
    monkeypatch.setattr(jax.random, "uniform", record)
    table = {name: ((f"Conv_{i}", "Conv_0"), "conv")
             for i, name in enumerate(("_q", "_k", "_v", "_z"))}
    queue = []

    def draw(shape):
        u = torch.from_numpy(queue.pop(0).copy())
        assert tuple(u.shape) == tuple(shape)
        return u
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 4, 5, 8))
    jaxModule = jnn.NonLocalBlock(maskRate=0.5, dtype=F64)
    with jax.enable_x64(), jax.disable_jit():
        flat, variables = seededParams(jaxModule, jnp.asarray(x), rng)
        recorded.clear()
        want = np.asarray(jaxModule.apply(variables, jnp.asarray(x), train=True,
                                          rngs={"dropout": jax.random.PRNGKey(3)}))
        eval_ = np.asarray(jaxModule.apply(variables, jnp.asarray(x)))
    assert len(recorded) == 1 and recorded[0].shape == (2, 20, 20)
    assert 0.3 < (recorded[0] < 0.5).mean() < 0.7
    queue.append(recorded[0])
    model = tnn.NonLocalBlock(8, maskRate=0.5).double()
    model.load_state_dict(portState(flat, table), strict=True)
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2)), draw=draw).numpy()
    got = got.transpose(0, 2, 3, 1)
    assert not queue
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ROUNDED)
    assert np.abs(want - eval_).max() > 1e-3            # the mask changed the output
    with pytest.raises(ValueError, match="draw"):
        model(torch.from_numpy(x.transpose(0, 3, 1, 2)))


def test_pixel_unshuffle_channel_order_is_the_jax_packages():
    """(c, i, j) order at rate 1/2: the port's `pixelUnshuffle` against JAX
    `nn/functional.py::pixelUnshuffle` on NHWC."""
    from mcquic_tpu.nn.functional import pixelUnshuffle as jaxUnshuffle
    from mcquic_tpu_torch.nn.functional import pixelUnshuffle
    x = np.arange(2 * 6 * 4 * 3, dtype=np.float64).reshape(2, 6, 4, 3)
    want = np.asarray(jaxUnshuffle(jnp.asarray(x), 2))
    got = pixelUnshuffle(torch.from_numpy(x.transpose(0, 3, 1, 2)), 2).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(got, want)


def test_masked_conv_masks_on_every_forward():
    """A weight written into a masked tap changes nothing: the mask is
    multiplied in at each call, not once at construction."""
    conv = tnn.MaskedConv(2, 3, 5, "A").double()
    x = torch.randn(1, 2, 7, 7, dtype=torch.float64)
    before = conv(x)
    with torch.no_grad():
        conv.weight[:, :, 2, 2:] = 100.0          # the centre (type A) and the taps after it
        conv.weight[:, :, 3:, :] = 100.0
    torch.testing.assert_close(conv(x), before, rtol=0, atol=0)
    assert "mask" not in conv.state_dict()
    with pytest.raises(ValueError, match="maskType"):
        tnn.MaskedConv(2, 3, 5, "C")
