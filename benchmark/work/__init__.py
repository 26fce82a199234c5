"""Frozen work counts: operations and bytes from the configuration's shapes."""
