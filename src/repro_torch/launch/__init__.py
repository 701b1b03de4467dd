"""Device meshes of the port (``repro.launch``): the datastore's edge and
fleet meshes and the multi-process fleet world (``mesh``), and the
two-process smoke of the fleet runtime (``multihost_smoke``)."""
