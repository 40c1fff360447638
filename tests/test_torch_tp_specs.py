"""`parallel.generatorShardings` against the JAX package's
(`mcquic_tpu/parallel/__init__.py:83`), on the CPU, for the generator of
tests/test_train_convergence.py::test_generator_tp_shardings_specs (channel
8, k 16, size (2, 1, 1), hidden 32, depth 1, 4 heads, 10 classes), its
text-conditioned form and a small GeneratorVAR.

Through the port's converter name map (`utils/convert.py::generatorMapOf`),
every flax kernel the JAX package marks `(None, "model")` is a weight the
port gives `Shard(0)`, every `("model", None)` one it gives `Shard(1)`, and
every other leaf is `Replicate()` (the port's code frequencies, the JAX
package's `coder` collection, too); at tensor-parallel size 1 everything is
replicated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

import mcquic_tpu.models.generator_var as jaxVar
from mcquic_tpu.models.generator import GeneratorV3SelfAttention as JaxGenerator
from mcquic_tpu.parallel import generatorShardings as jaxGeneratorShardings
from mcquic_tpu.parallel import makeMesh
from mcquic_tpu_torch.models.generator import GeneratorV3SelfAttention
from mcquic_tpu_torch.models.generator_var import GeneratorVAR
from mcquic_tpu_torch.parallel import generatorShardings
from mcquic_tpu_torch.utils.convert import (generatorGeometry, generatorMapOf, halvingOf,
                                            toJaxGeneratorParams)
from test_torch_generator import seededGeneratorFlat

CASES = {
    "GeneratorV3SelfAttention": (JaxGenerator, GeneratorV3SelfAttention,
                                 dict(channel=8, k=16, size=(2, 1, 1), hiddenSize=32, depth=1,
                                      nHeads=4, numClasses=10)),
    "textConditioned": (JaxGenerator, GeneratorV3SelfAttention,
                        dict(channel=8, k=16, size=(2, 1, 1), hiddenSize=32, depth=1, nHeads=4,
                             textConditioned=True, capDim=12)),
    "GeneratorVAR": (jaxVar.GeneratorVAR, GeneratorVAR,
                     dict(channel=8, k=16, size=(2, 1, 1), depth=2, embedDim=64, nHeads=4,
                          numClasses=10)),
}


def _flat(jaxClass, portClass, geometry):
    """The flat flax variables of the geometry. The JAX text-conditioned
    generator cannot be initialized from class ids, so its tree is the
    port's state dict through the inverse map, as in
    tests/test_torch_text_generator.py."""
    if geometry.get("textConditioned"):
        return toJaxGeneratorParams(portClass(**geometry).state_dict(), halvingOf(geometry["size"]),
                                    geometry["depth"], textConditioned=True)
    return seededGeneratorFlat(geometry, jaxClass=jaxClass)


def _jaxSpecs(flat, modelParallel):
    """{flax key (`params/...`): the JAX package's spec as a tuple}."""
    params = {}
    for key, value in flat.items():
        if key.startswith("params/"):
            node = params
            parts = key.split("/")[1:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.zeros(np.shape(value))
    mesh = makeMesh(dataParallel=8 // modelParallel, modelParallel=modelParallel)
    specs = jax.tree_util.tree_flatten_with_path(jaxGeneratorShardings(mesh, params))[0]
    return {"params/" + "/".join(p.key for p in path): tuple(s.spec) for path, s in specs}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("tpSize", [2, 1])
def test_placements_match_the_jax_specs(case, tpSize):
    jaxClass, portClass, geometry = CASES[case]
    flat = _flat(jaxClass, portClass, geometry)
    specs = _jaxSpecs(flat, tpSize)
    placements = generatorShardings(portClass(**geometry), tpSize)
    entries = generatorMapOf(generatorGeometry(flat)).entries
    assert set(placements) == set(entries)
    want = {(None, "model"): Shard(0), ("model", None): Shard(1)}
    sharded = 0
    for torchKey, placement in placements.items():
        flaxKey = entries[torchKey][0]
        spec = specs[flaxKey] if flaxKey.startswith("params/") else ()     # coder/: not params
        assert placement == want.get(spec, Replicate()), (torchKey, spec, placement)
        sharded += placement != Replicate()
    if tpSize == 1:
        assert sharded == 0
    else:
        assert sharded > 0
        assert all(placements[k] == Replicate() for k in placements if k.startswith("compressor."))
