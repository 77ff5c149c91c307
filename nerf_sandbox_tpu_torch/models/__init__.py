"""The NeRF MLP and the stateless forward pass (ports of ``models/``)."""
