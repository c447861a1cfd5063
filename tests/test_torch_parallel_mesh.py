"""The port's device mesh (``parallel/mesh.py``) against the JAX
package's: the mesh shapes of ``make_mesh``/``make_expand_mesh`` and the
refusal of a model axis that does not divide the devices, shards and their
gathering, the collectives' gradients; and the expansion driver on a
2-device CPU data mesh, whose PNGs are within one level of the one-device
run's (the per-unit generators do not depend on the mesh)."""

import os

import jax
import numpy as np
import pytest
import torch

from distdiff_tpu.parallel import mesh as j_mesh
from distdiff_tpu_torch.parallel import mesh

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.mark.parametrize("n_model", [1, 2, 4])
def test_expand_meshes_have_the_jax_shapes(n_model):
    want = dict(j_mesh.make_expand_mesh(n_model, jax.devices()[:8]).shape)
    got = mesh.make_expand_mesh(n_model, [CPU] * 8)
    assert got.shape == want and got.size == 8
    assert len(mesh.data_groups(got)) == want["data"]
    assert all(len(g) == 8 // want["data"] for g in mesh.data_groups(got))


def test_a_model_axis_that_does_not_divide_is_refused_as_jax_asserts(monkeypatch):
    with pytest.raises(AssertionError, match="--mesh_model 3 does not divide 8 devices"):
        j_mesh.make_expand_mesh(3, jax.devices()[:8])
    with pytest.raises(ValueError, match="--mesh_model 3 does not divide 8 devices"):
        mesh.make_expand_mesh(3, [CPU] * 8)
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    assert mesh.local_devices() == [CPU]
    assert mesh.make_mesh().shape == {"data": 1}


def test_shards_gather_back_and_replicas_share_one_tensor():
    m = mesh.make_expand_mesh(2, [CPU] * 4)  # data 2 x model 2
    x = torch.arange(4 * 6, dtype=torch.float32).reshape(4, 6)
    rows = mesh.data_sharding(m)(x)
    assert rows.shape == (2, 2) and torch.equal(rows[1, 0], x[2:])
    assert rows[0, 0] is rows[0, 1]  # one copy per shard and device
    assert torch.equal(mesh.data_sharding(m).gather(rows, CPU), x)
    cols = mesh.NamedSharding(m, mesh.P(None, "model"))(x)
    assert torch.equal(cols[0, 1], x[:, 3:])
    assert torch.equal(mesh.NamedSharding(m, mesh.P(None, "model")).gather(cols, CPU), x)
    whole = mesh.replicated(m)(x)
    assert all(t.data_ptr() == x.data_ptr() for t in whole.reshape(-1))
    with pytest.raises(ValueError, match="does not split"):
        mesh.NamedSharding(m, mesh.P(None, "model"))(torch.zeros(4, 5))


def test_the_collectives_transpose_under_autograd():
    """all_reduce's gradient is the broadcast of the cotangent, all_gather's
    the cotangent's slices, ppermute's the cotangent itself; ppermute
    leaves its input as it was."""
    a, b = (torch.randn(3, generator=torch.Generator().manual_seed(s), requires_grad=True)
            for s in (0, 1))
    w = torch.tensor([1.0, 2.0, 3.0])
    ga, gb = torch.autograd.grad((mesh.all_reduce([a, b], CPU) * w).sum(), (a, b))
    assert torch.equal(ga, w) and torch.equal(gb, w)
    ga, gb = torch.autograd.grad((mesh.all_gather([a, b], 0, CPU) * torch.arange(6.0)).sum(),
                                 (a, b))
    assert torch.equal(ga, torch.arange(3.0)) and torch.equal(gb, torch.arange(3.0, 6.0))
    assert mesh.ppermute(a, CPU) is a


class _ToyDataset:
    """``SDDataset``'s surface for the driver: 3 images of 2 classes with
    seeded latents and conditionings."""

    def __init__(self, root, ls):
        rng = np.random.RandomState(2)
        self.image_paths = [os.path.join(root, f"img_{i}.png") for i in range(3)]
        self.class_names = ["alpha", "beta"]
        self.labels = [0, 1, 1]
        self._items = [dict(latent=(rng.randn(ls, ls, 4) * 0.2).astype(np.float32),
                            cond=rng.randn(8, 32).astype(np.float32),
                            uncond=rng.randn(8, 32).astype(np.float32), target=lab)
                       for lab in self.labels]

    def __getitem__(self, i):
        return type("Item", (), self._items[i])


def test_the_driver_on_a_data_mesh_writes_the_one_device_images(tmp_path):
    """4 units (2 images x 2) in batches of 2 a data shard on a 2-device
    data mesh, against batches of 2 on one device: the same PNGs at the same
    paths, within one level."""
    from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig
    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.parallel import ExpansionDriver, read_png
    from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig

    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    guide = create_model("tiny_resnet", num_classes=2, device="cpu")
    pipe = ExpansionPipeline.create(
        PipelineConfig.tiny(sample_size=32), sampler_cfg=SamplerConfig(guidance_scale=3.0),
        guidance_cfg=GuidanceConfig(guidance_type="transform_guidance", guidance_step=4,
                                    guidance_period=2, K=2, guide_input_size=32),
        guide=guide, global_protos=rng.randn(2, guide.feature_dim).astype(np.float32),
        local_protos=rng.randn(2, 2, guide.feature_dim).astype(np.float32), device="cpu")
    sd = _ToyDataset(str(tmp_path), pipe.config.latent_size)
    pngs = {}
    for name, m in (("one", None), ("mesh", mesh.make_mesh([CPU] * 2))):
        out = str(tmp_path / name)
        drv = ExpansionDriver(pipe.make_split_expand(mesh=m), sd, out, batch_size=2,
                              seed=3, device="cpu", mesh=m)
        assert drv.global_batch == (4 if m else 2)
        try:
            stats = drv.run(num_images_per_prompt=2, max_units=4)
        finally:
            drv.close()
        assert stats["written"] == 4
        pngs[name] = {os.path.relpath(os.path.join(d, f), out): read_png(os.path.join(d, f))
                      for d, _, fs in os.walk(out) for f in fs}
    assert sorted(pngs["mesh"]) == sorted(pngs["one"]) and len(pngs["one"]) == 4
    for p, img in pngs["one"].items():
        assert np.abs(pngs["mesh"][p].astype(int) - img.astype(int)).max() <= 1, p
