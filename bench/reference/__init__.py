"""Plain PyTorch references, one module per architecture, named by a
configuration file's ``architecture``."""
