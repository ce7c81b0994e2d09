"""Multi-device solving over torch.distributed: the collectives
(``comm``), the rank-local problem and sharded chunks (``shardmap``),
meshes and placement (``spmd``) and multi-process bring-up
(``multihost``). Counterpart of the JAX package's ``parallel/``."""
