from zgml.utils.cli import main

main()
