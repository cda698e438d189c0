"""Triangle precompute, ray/box predicates, room geometry and scene
export: copies of pffdtd_tpu/geometry."""

from pffdtd_tpu_torch.geometry.tris import TriPre, tris_precompute  # noqa: F401
from pffdtd_tpu_torch.geometry.predicates import (  # noqa: F401
    tri_ray_intersect,
    tri_box_intersect,
)
from pffdtd_tpu_torch.geometry.room import RoomGeo  # noqa: F401
from pffdtd_tpu_torch.geometry.box import Box  # noqa: F401
