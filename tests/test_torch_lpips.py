"""The port's LPIPS against the JAX package's (`mcquic_tpu/loss/lpips.py`),
fp64, on numpy-seeded VGG16 weights (a torchvision-style state dict, which
both packages convert with their own `convertVggStateDict`) and the bundled
lin heads: the value and its gradient with respect to xHat, through the
224x224 resize. Held to 16 fp32 ulps of their largest magnitude, the
parity tolerance of the port's tests; the normalizing constants are fp32 in
both packages.

The backbone's gating: no weights give None and one warning; the proxy
(MCQUIC_LPIPS_PROXY=1) gives a finite term.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcquic_tpu.loss import lpips as jaxLpips
from mcquic_tpu_torch.loss import lpips

TOL = 16 * 2 ** -23
VGG_CONV_INDEX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]    # torchvision vgg16.features


def seededVgg(seed=0) -> dict:
    """A torchvision-style VGG16 state dict of numpy arrays, He-scaled."""
    rng = np.random.default_rng(seed)
    out, inChannels, i = {}, 3, 0
    for channels, count in lpips.VGG_STAGES:
        for _ in range(count):
            std = np.sqrt(2.0 / (9 * inChannels))
            out[f"features.{VGG_CONV_INDEX[i]}.weight"] = rng.normal(size=(channels, inChannels, 3, 3)) * std
            out[f"features.{VGG_CONV_INDEX[i]}.bias"] = rng.uniform(-0.05, 0.05, channels)
            inChannels, i = channels, i + 1
    return out


def portLpips(vsd) -> lpips.LPIPS:
    module = lpips.LPIPS()
    module.load_state_dict({**lpips.loadBundledLinHeads(), **lpips.convertVggStateDict(vsd)},
                           strict=True)
    return module.double()


def _assertClose(got, want, label):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=label)


def test_value_and_gradient_equal_jax_through_the_resize():
    vsd = seededVgg()
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (1, 64, 64, 3))
    xHat = np.clip(x + rng.normal(size=x.shape) * 0.2, -1, 1)
    params = jaxLpips.loadBundledLinHeads()
    params["vgg"] = jaxLpips.convertVggStateDict(vsd)
    with jax.enable_x64():
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        fn = jaxLpips.makeLpipsFn(params, dtype=jnp.float64)
        value, grad = jax.jit(jax.value_and_grad(fn))(jnp.asarray(xHat), jnp.asarray(x))
        value, grad = float(value), np.asarray(grad)
    fn = lpips.makeLpipsFn(portLpips(vsd))
    ours = torch.from_numpy(xHat.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    got = fn(ours, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    got.backward()
    assert value > 0
    assert abs(got.item() - value) <= TOL * max(1.0, abs(value)), (got.item(), value)
    _assertClose(ours.grad.numpy().transpose(0, 2, 3, 1), grad, "d lpips / d xHat")


@pytest.mark.parametrize("size", [64, 256, 300])
def test_resize_is_the_jax_bilinear_resize(size):
    """224 from 64 grows, from 256 and 300 shrinks (antialiased)."""
    x = np.random.default_rng(size).normal(size=(2, size, size, 3))
    with jax.enable_x64():
        want = np.asarray(jaxLpips._bilinearResize(jnp.asarray(x)))
    got = lpips.resize224(torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=0, atol=1e-12)


def test_bundled_lin_heads_equal_the_jax_package():
    with np.load(lpips.BUNDLED_LIN) as ours, np.load(jaxLpips.BUNDLED_LIN) as theirs:
        assert sorted(ours.files) == sorted(theirs.files) == [f"lin{i}" for i in range(5)]
        for name in ours.files:
            np.testing.assert_array_equal(ours[name], theirs[name])
    heads = lpips.loadBundledLinHeads()
    assert [tuple(heads[f"lin{i}.weight"].shape) for i in range(5)] == [
        (1, c, 1, 1) for c, _ in lpips.VGG_STAGES]


def test_backbone_from_the_environment(tmp_path, monkeypatch):
    vsd = {k: torch.from_numpy(v).float() for k, v in seededVgg(2).items()}
    path = tmp_path / "vgg16.pth"
    torch.save(vsd, path)
    monkeypatch.setenv("MCQUIC_VGG16_WEIGHTS", str(path))
    monkeypatch.delenv("MCQUIC_LPIPS_PROXY", raising=False)
    assert lpips.findVggWeights() == str(path)
    fn = lpips.makeDefaultLpipsFn("cpu")
    x = torch.rand(1, 3, 32, 32) * 2 - 1
    assert float(fn(x, x)) == 0.0
    assert float(fn(x.flip(3), x)) > 0


def test_no_backbone_gives_none_and_one_warning_and_the_proxy_a_finite_term(tmp_path, monkeypatch,
                                                                           caplog, capsys):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("MCQUIC_VGG16_WEIGHTS", raising=False)
    monkeypatch.delenv("MCQUIC_LPIPS_PROXY", raising=False)
    monkeypatch.setattr(lpips, "_warnedOnce", False)
    with caplog.at_level("WARNING", logger="mcquic_tpu_torch.lpips"):
        assert lpips.makeDefaultLpipsFn("cpu") is None
        assert lpips.makeDefaultLpipsFn("cpu") is None
    assert sum("LPIPS DISABLED" in r.getMessage() for r in caplog.records) == 1
    assert capsys.readouterr().out.count("LPIPS DISABLED") == 1
    monkeypatch.setenv("MCQUIC_LPIPS_PROXY", "1")
    fn = lpips.makeDefaultLpipsFn("cpu")
    assert "LPIPS PROXY ACTIVE" in capsys.readouterr().out
    x = torch.rand(2, 3, 32, 32) * 2 - 1
    y = (x + 0.3 * torch.randn_like(x)).clamp(-1, 1).requires_grad_(True)
    value = fn(y, x)
    value.backward()
    assert torch.isfinite(value) and float(value) > 0 and torch.isfinite(y.grad).all()
    again = lpips.proxyModule()
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(),
                                                 lpips.proxyModule().state_dict().values()))
