"""Loops: what runs a traffic mix through a model family's entry, one
module each, named by a traffic file's ``loop``."""
