"""The LM side of the port: layers, attention, the dense decoder stack
(``model``) and the carrying of the reference's parameters (``convert``)."""
