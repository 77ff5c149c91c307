"""Eval rendering (ports of ``render/``)."""
