"""Launch layer of the port: meshes, the roofline and the dry run."""
