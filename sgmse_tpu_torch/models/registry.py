"""Backbone registry."""
from ..utils.registry import Registry

BackboneRegistry = Registry("Backbone")
