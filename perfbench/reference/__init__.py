"""The plain float32 references that decide `correct`; they import
nothing of the program."""
