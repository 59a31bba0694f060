"""Mesh placement of the port's trees: the sharding rules
(``sharding``) and the activation-hint context (``ctx``)."""
