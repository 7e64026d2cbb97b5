"""Plain references: one module per model family, and the MLL-SGD tick."""
