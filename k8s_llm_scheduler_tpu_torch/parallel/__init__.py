"""Rank meshes, Megatron partition specs, the multi-host world, and the
spawn and mirror of a tensor-parallel group's processes (launch.py)."""
