"""Densities a traffic mix draws its inputs from, one file each, found by name."""
