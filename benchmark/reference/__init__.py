"""The benchmark's plain reference: what decides ``correct``. It imports
torch and numpy alone, and nothing of the program."""
