"""How a traffic mix drives the program, by the name in its ``route``."""
