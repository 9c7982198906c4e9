"""Frontend: lexer + plan/schema parsers (reference Scanner.x / Parser.y / SchemaParser.y)."""
