"""Multi-device layout of the port (``repro.distributed``): the edge axis's
contiguous blocks and their layout contract (``sharding``) and the
federated runtime on a datastore mesh (``federation``): the 1-D edge mesh
and the 2-D fleet mesh, in one process or one process a fleet over
``torch.distributed`` with gloo.
"""
