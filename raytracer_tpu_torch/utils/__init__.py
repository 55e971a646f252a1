"""Host utilities: render configuration, OBJ parsing, image output."""
