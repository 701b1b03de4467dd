"""Multi-device layout of the port (``repro.distributed``): the edge axis's
contiguous blocks and their layout contract (``sharding``) and the
federated runtime on a one-process edge mesh (``federation``). The 2-D
fleet mesh and the multi-process runtime are a later slice (ROADMAP Queue
1, item 7.2).
"""
