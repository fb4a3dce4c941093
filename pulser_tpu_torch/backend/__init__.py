"""Result containers shared by the emulator (trimmed; see ROADMAP.md)."""
