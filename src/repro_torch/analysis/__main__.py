from .cli import main

if __name__ == "__main__":  # importing the module (as the import checks do) runs nothing
    raise SystemExit(main())
