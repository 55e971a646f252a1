"""Measurements on the card that are not part of a render."""
