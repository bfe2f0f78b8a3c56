"""Launch layer of the port: the serve driver (twin of ``repro.launch``;
the train driver and the dry-run tools come later)."""
