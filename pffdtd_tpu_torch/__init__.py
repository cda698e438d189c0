"""pffdtd_tpu_torch — the PyTorch + CUDA port of pffdtd_tpu for NVIDIA Hopper.

The JAX package `pffdtd_tpu` is the reference; this package computes the
same FDTD update (mirror halo flips, adjacency-masked 7/13-point stencil with
the leapfrog, the lossy-boundary ODE, Engquist-Majda ABCs, sources and
receivers) with PyTorch tensors on the host side and hand-written CUDA
kernels on the card, one step per launch (K1 + K2) or TB steps per launch
(K3), on one device or as x-slabs over a list of devices (K5, K6: the
shard modes of K1 and K3).  Nothing here imports `jax` or `pffdtd_tpu`;
`h5py`, `matplotlib` and `scipy` are imported only inside the functions
that need them.  The host stages before the engine (room
geometry, the voxelizer and its native C++/OpenMP backend, material
fitting, setup into a sim folder, `prep`) and the NumPy oracle are numpy
copies of the JAX package's.

Subpackages
-----------
- ``io``         numpy-only sim-folder dataclasses + lazy HDF5 read/write
- ``geometry``   triangle precompute, ray/box predicates, RoomGeo, Box,
                 model-JSON export
- ``voxelizer``  CartGrid, VoxScene (numpy blocks, or the native backend
                 built with g++ into ``_build/``), the adjacency check
- ``materials``  admittance conversions, DEF files, fit_to_Sabs_oct_11
- ``scene_setup`` room -> voxelized SimData or sim folder
- ``prep``       rotate ("auto") / fold / sort of a sim folder
- ``engine``     coefficients, host-side static arrays and tile lists, the
                 TorchEngine runner (chunks, hook, checkpoint/resume), the
                 energy functionals and the NumPy oracle NumpyEngine
- ``kernels``    K1 (stencil + ABC), K2 (lossy boundary), K3 (TB steps per
                 sweep), K4 (bandwidth probe), K5 and K6 (K1 and K3 on an
                 x-slab) wrappers, each beside its plain PyTorch version,
                 and the nvcc/ctypes build step
- ``csrc``       the CUDA C++ sources of K1-K6
- ``parallel``   the x-slab partition and ShardedTorchEngine /
                 make_sharded_engine over a device list
- ``scene``      the demo shoebox room, synthetic box scenes and the
                 in-memory rotate/fold/sort
- ``consts``, ``comms``, ``utils``
                 copies of the JAX package's numpy-only helpers
- ``convert``    state carried across from the JAX engines' layouts
- ``viz``        wavefield slices, the voxelization draw, the live view,
                 animation frames, RIRs
- ``analysis``   air absorption (the modal filter on a device) and the
                 ``process`` stage
- ``cli``        ``python -m pffdtd_tpu_torch.cli
                 sim|process|prep|fit-material``
"""

__version__ = "0.4.0"
