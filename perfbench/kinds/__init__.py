"""How each kind of configuration is set up, driven and checked."""
