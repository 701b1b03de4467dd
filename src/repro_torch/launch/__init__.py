"""Device meshes of the port (``repro.launch``): the one-process edge mesh
of the federated datastore (``mesh.make_edge_mesh``)."""
