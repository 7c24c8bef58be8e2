"""The pose gradient of the port against ``jax.grad`` of the JAX package in
the bench frame at 48x48: VSM, fast SSAO, textures, the image-based light
with skybox and the background plane (``test_torch_grad.py`` has the loss,
the mask, the other cases and the tolerances: 2e-2 per object here, VSM
being on). Differentiating through the port's plain z-buffer, as the port
did before it cut the gradient where the JAX package does, gives this case
errors of 0.63 and 0.89 of two objects' largest components."""

import pytest

from test_torch_grad import check_gradients, settled
from torch_port_scene import build_full_meshes, jax_full_template, jax_light_map


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    """The textured blob, cube and sphere with the plane and the light map."""
    cube, sphere, blob, _ = build_full_meshes(str(tmp_path_factory.mktemp("full")), native_decomp=False)
    return settled(jax_full_template((cube, sphere, blob), jax_light_map()))


def test_pose_gradient_matches_jax_bench(full):
    check_gradients(full, "bench")
