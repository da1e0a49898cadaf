"""DGN layers."""
