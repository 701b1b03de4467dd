"""Multi-device layout of the port (``repro.distributed``). So far only the
failure-domain blocks of the edge axis (``sharding.device_edge_block``);
the federated runtime is a later slice (ROADMAP Queue 1, item 7).
"""
