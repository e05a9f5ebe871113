"""The flagship backbone, DLA-102 with the deformable necks (DLASeg), held
against JAX in float64 at 64x128.

The other port tests hold dla34 in numbers; DLA-102 in float32 lies some
2e-4 of its largest output from float64 through its depth alone, which
would hide a layer's fault. In float64 both frameworks agree to rounding
(4.9e-7 of the largest output in a probe), so a fault shows. JAX runs in
64-bit inside a `jax.enable_x64` context only, so the other tests of the
worker keep 32-bit JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from m3dssd_tpu.models.necks import DLASeg as JDLASeg
from m3dssd_tpu_torch.models.necks import DCN, DLASeg
from m3dssd_tpu_torch.utils.weights import from_flax_variables

# one torch thread per test process (see tests/test_torch_train.py)
torch.set_num_threads(1)

CROP = (64, 128)
TOL = 2e-6     # of the largest output; the probe read 4.9e-7


def _perturb(tree, seed):
    """BN statistics and affine, biases and the zero-initialised DCN
    offset/mask convs moved off their init (neck offsets then pass +-1)."""
    rng = np.random.default_rng(seed)

    def walk(t, path):
        out = {}
        for k, v in t.items():
            p = path + (k,)
            if hasattr(v, "items"):
                out[k] = walk(v, p)
                continue
            a = np.array(v, np.float32)
            if "conv_offset_mask" in p and k == "kernel":
                a = rng.normal(size=a.shape) * (3.0 / np.sqrt(
                    np.prod(a.shape[:3])))
            elif "conv_offset_mask" in p and k == "bias":
                a = rng.normal(size=a.shape) * 0.3
            elif k == "scale" or k == "var":
                a = rng.uniform(0.5, 1.5, size=a.shape)
            elif k in ("bias", "mean"):
                a = a + rng.normal(size=a.shape) * 0.1
            out[k] = a.astype(np.float32)
        return out

    return walk(jax.tree_util.tree_map(np.asarray, dict(tree)), ())


def test_dla102_dlaseg_matches_jax_in_float64():
    images = np.random.default_rng(0).normal(
        size=(1,) + CROP + (3,)).astype(np.float32)
    with jax.enable_x64(True):
        jmod = JDLASeg(base_name="dla102", use_dcn=True, shift_clamp=1.0,
                       dtype=jnp.float64)
        variables = _perturb(jmod.init(jax.random.PRNGKey(0),
                                       jnp.asarray(images), train=False), 1)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        want = np.asarray(jmod.apply(v64, jnp.asarray(images, jnp.float64),
                                     train=False))
    assert want.dtype == np.float64

    mod = DLASeg("dla102", use_dcn=True, shift_clamp=1.0)
    mod.load_state_dict(from_flax_variables(variables), strict=True)
    mod = mod.double().eval()
    assert sum(m.uses_shift for m in mod.modules()
               if isinstance(m, DCN)) == 8
    with torch.inference_mode():
        got = mod(torch.from_numpy(images).double())
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < TOL, err
