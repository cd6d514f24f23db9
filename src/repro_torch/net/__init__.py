"""Fabric, flows, chaos injectors and the fluid rate dynamics."""
