"""Ray generation, encoding, sampling and compositing (ports of ``core/``)."""
