"""Model families: how the program builds each one, beside its plain reference."""
